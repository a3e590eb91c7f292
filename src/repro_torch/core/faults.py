"""Seeded fault injection + the recovery policies the scheduler runs under.

The scheduler stack is grown toward a real distributed deployment
(ROADMAP: scheduler-as-a-service) where shard eligibility launches, build
workers and accelerator kernels are separate processes that hang, crash
and misbehave.  This module makes those failures *first-class test
inputs*: a `FaultPlan` is a seeded, deterministic description of what
breaks where, injected at four named seams —

  ===================  =====================================  ==========
  seam                 injected at                            recovery
  ===================  =====================================  ==========
  ``shard_launch``     `ShardedMatcher` per-shard batched     retry w/ backoff,
                       eligibility launch (raise / hang)      quarantine -> all-
                                                              eligible mask (exact)
  ``build_worker``     `BuildService` worker executing        retry w/ backoff,
                       ``_build_slim`` (raise / crash)        digest quarantine,
                                                              inline fallback (exact)
  ``kernel_impl``      kernel dispatch of a non-numpy impl    sticky demotion down
                       (raise)                                the impl chain (exact)
  ``heartbeat``        simulated machine heartbeat            suspicion -> declared
                       (drop / delay)                         lost -> requeue ->
                                                              rejoin (lossy)
  ``memo``             construction-memo entry lookup         checksum-validated
                       (corrupt / drop)                       entries: a bad or
                                                              evicted entry is a
                                                              miss -> live search
                                                              (exact)
  ``comm_send``        service comm layer, one message send   seq-numbered idempo-
                       (drop / delay / dup)                   tent channels: acks,
                                                              capped-backoff re-
                                                              transmit, dup/reorder
                                                              gating (exact)
  ``agent``            worker-agent process                   lease reclaim on
                       (crash / partition)                    heartbeat silence ->
                                                              requeue -> rejoin
                                                              (lossy)
  ===================  =====================================  ==========

The code-seam recoveries are **decision-exact**: shard quarantine
substitutes the conservative all-eligible mask, which is a sound
superset of the real eligibility columns (`machines_with_candidates`
only ever *skips* provably-idle machines — PR 4's soundness argument),
so the matcher visits more machines but picks identically; build retries
and the inline fallback recompute the same pure function of DAG content;
kernel demotion lands on the always-available numpy oracle that defines
correct output.  Heartbeat loss genuinely changes cluster state and is
the one *lossy* seam (documented in docs/architecture.md).

Determinism: every probabilistic injection decision is a pure function
of (plan seed, spec index, seam, call context) via a keyed blake2b hash
— never Python's salted ``hash()`` — so a plan fires at the same call
sites regardless of thread interleaving, process boundaries or replay
order.  ``REPRO_FAULTS`` carries a plan into worker processes by env.

Plan spec grammar (env var and `FaultPlan.parse`)::

    seed=7;shard_launch:raise@0.3;shard_launch:hang@0.1,delay=0.2;
    build_worker:crash@1.0,attempt_lt=2;heartbeat:drop@0.05

i.e. ``;``-separated clauses, each ``seam[:kind][@prob][,key=value...]``
where extra keys are either spec knobs (``delay``, ``count`` = max
injections) or context match filters (``shard=0``, ``attempt_lt=2`` —
the ``_lt`` suffix matches when ctx[key] < value).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from contextlib import contextmanager

#: env var carrying a plan spec string into every process of a run
FAULTS_ENV = "REPRO_FAULTS"

SEAMS = ("shard_launch", "build_worker", "kernel_impl", "heartbeat", "memo",
         "comm_send", "agent")
#: seams whose recovery reproduces the fault-free decisions bit-for-bit
#: (comm_send qualifies: retransmit + sequence gating make any delivered
#: schedule of dups/reorders/drops collapse to the clean-delivery one)
EXACT_SEAMS = frozenset({"shard_launch", "build_worker", "kernel_impl",
                         "memo", "comm_send"})
KINDS = ("raise", "hang", "crash", "drop", "delay", "corrupt", "dup",
         "partition", "oom", "misaligned")


class InjectedFault(RuntimeError):
    """The exception raised by ``raise``-kind injections (and nothing
    else), so recovery paths can be asserted against real bugs."""

    def __init__(self, seam: str, ctx: dict):
        super().__init__(f"injected fault at seam {seam!r} ({ctx})")
        self.seam = seam
        self.ctx = ctx

    def __reduce__(self):
        # a build worker process sends it back to the service pickled
        return type(self), (self.seam, self.ctx)


class SimulatedOOM(InjectedFault):
    """``oom``-kind injection: models a device allocator failure inside a
    kernel impl (lets tests walk the demotion chain without exhausting
    real device memory);
    caught by dispatch like any impl error -> sticky demotion."""


class SimulatedMisalignedGrid(InjectedFault):
    """``misaligned``-kind injection: models a grid/block-shape mismatch
    raised at kernel trace time; recovery is identical to ``oom``."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection clause: where, what, how often, and to whom."""

    seam: str
    kind: str = "raise"
    prob: float = 1.0
    delay: float = 0.25            # hang sleep / heartbeat delay seconds
    max_count: int | None = None   # stop after this many injections
    #: context equality filters; a ``key_lt`` entry matches ctx[key] < v
    match: tuple[tuple[str, object], ...] = ()

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown fault seam {self.seam!r}; have {SEAMS}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; have {KINDS}")

    def matches(self, ctx: dict) -> bool:
        for k, v in self.match:
            if k.endswith("_lt"):
                got = ctx.get(k[:-3])
                if got is None or not got < v:
                    return False
            elif ctx.get(k) != v:
                return False
        return True


def _parse_value(raw: str):
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        return raw


class FaultPlan:
    """An ordered set of `FaultSpec` clauses + a seed + firing stats.

    ``query`` returns the first matching spec that decides to fire for a
    call context (recording it in ``stats``); the caller interprets the
    spec's *kind*.  ``maybe_fail`` is the common interpretation for code
    seams: raise `InjectedFault`, sleep, or kill the process.
    """

    def __init__(self, specs: tuple | list = (), seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._fired = [0] * len(self.specs)
        self._lock = threading.Lock()
        self.stats: dict[str, int] = {}

    # -- construction ---------------------------------------------------

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Plan from the spec grammar (module docstring); '' = empty."""
        seed = 0
        specs = []
        for clause in text.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if clause.startswith("seed="):
                seed = int(clause[5:])
                continue
            head, *opts = clause.split(",")
            prob = 1.0
            if "@" in head:
                head, p = head.rsplit("@", 1)
                prob = float(p)
            seam, _, kind = head.partition(":")
            kw: dict = {"seam": seam.strip(), "prob": prob}
            if kind.strip():
                kw["kind"] = kind.strip()
            match = []
            for opt in opts:
                k, _, v = opt.partition("=")
                k, val = k.strip(), _parse_value(v.strip())
                if k == "delay":
                    kw["delay"] = float(val)
                elif k == "count":
                    kw["max_count"] = int(val)
                else:
                    match.append((k, val))
            kw["match"] = tuple(match)
            specs.append(FaultSpec(**kw))
        return cls(specs, seed=seed)

    def describe(self) -> str:
        """Round-trippable spec string (``parse(describe())`` == plan)."""
        parts = [f"seed={self.seed}"]
        for sp in self.specs:
            s = f"{sp.seam}:{sp.kind}@{sp.prob:g}"
            if sp.delay != 0.25:
                s += f",delay={sp.delay:g}"
            if sp.max_count is not None:
                s += f",count={sp.max_count}"
            for k, v in sp.match:
                s += f",{k}={v}"
            parts.append(s)
        return ";".join(parts)

    def is_exact_recoverable(self) -> bool:
        """True iff every seam's recovery is decision-exact."""
        return all(sp.seam in EXACT_SEAMS for sp in self.specs)

    # -- firing decisions ----------------------------------------------

    def _u01(self, idx: int, seam: str, ctx: dict) -> float:
        key = repr((self.seed, idx, seam, sorted(ctx.items()))).encode()
        h = hashlib.blake2b(key, digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64

    def query(self, seam: str, **ctx) -> FaultSpec | None:
        """First spec that fires for this call, else None (stats-counted)."""
        for i, sp in enumerate(self.specs):
            if sp.seam != seam or not sp.matches(ctx):
                continue
            if sp.prob < 1.0 and self._u01(i, seam, ctx) >= sp.prob:
                continue
            with self._lock:
                if sp.max_count is not None and self._fired[i] >= sp.max_count:
                    continue
                self._fired[i] += 1
                k = f"{seam}.{sp.kind}"
                self.stats[k] = self.stats.get(k, 0) + 1
            return sp
        return None

    def maybe_fail(self, seam: str, **ctx) -> None:
        """Act out a firing spec at a code seam.

        raise/drop -> `InjectedFault`; oom/misaligned -> their simulated
        subclasses; hang/delay -> sleep ``delay`` wall-seconds; crash ->
        ``os._exit`` (worker-process seams only).  Kinds that only make
        sense to ``query``-interpreting seams (dup, partition, corrupt)
        are no-ops here.
        """
        sp = self.query(seam, **ctx)
        if sp is None:
            return
        if sp.kind in ("raise", "drop"):
            raise InjectedFault(seam, ctx)
        if sp.kind == "oom":
            raise SimulatedOOM(seam, ctx)
        if sp.kind == "misaligned":
            raise SimulatedMisalignedGrid(seam, ctx)
        if sp.kind in ("hang", "delay"):
            time.sleep(max(sp.delay, 0.0))
            return
        if sp.kind == "crash":
            os._exit(13)                      # crash: hard worker death

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self.stats)


@dataclasses.dataclass
class RecoveryPolicy:
    """Shared knobs of the degraded-mode recoveries (wall-clock units).

    One policy object covers the sharded matcher (launch timeout/retry/
    quarantine/probe) and the build service (retry budget + backoff);
    `SimConfig.recovery` threads it through both.
    """

    launch_timeout: float | None = 30.0  # per shard-launch attempt; None = no cap
    launch_retries: int = 2              # extra attempts after the first
    backoff: float = 0.05                # base of the capped exponential backoff
    backoff_cap: float = 1.0
    quarantine_after: int = 3            # consecutive shard-launch failures
    #: quarantined-shard probe cadence.  ``probe_every`` counts waves and
    #: acts as a *floor* (never probe more often than every N waves);
    #: ``probe_secs`` is the wall-clock trigger, so long waves cannot
    #: starve probes — a shard is probed once max(probe_every waves,
    #: probe_secs seconds) has elapsed, whichever is FIRST beyond the
    #: 1-wave minimum.  ``probe_secs=None`` restores pure wave counting.
    probe_every: int = 50
    probe_secs: float | None = 30.0
    build_retries: int = 3               # pool attempts before inline fallback
    #: service RPC reliability (svc/comm.py Channel): first retransmit of
    #: an unacked message after ``rpc_timeout``, then exponential backoff
    #: capped at ``backoff_cap``.  The agent reconnect loop reuses
    #: ``backoff``/``backoff_cap`` and additionally caps every wait at
    #: ``probe_secs`` so a long backoff can never starve rejoin.
    rpc_timeout: float = 0.25


# ----------------------------------------------------------------------
# ambient plan (process-wide, env-seeded) + thread-local suppression
# ----------------------------------------------------------------------

_ACTIVE: FaultPlan | None = None
_ENV_CACHE: tuple[str, FaultPlan] | None = None
_TLS = threading.local()


def install(plan: FaultPlan | str | None) -> FaultPlan | None:
    """Set the process-wide plan (str = spec grammar; None = env only)."""
    global _ACTIVE
    _ACTIVE = coerce(plan)
    return _ACTIVE


def uninstall() -> None:
    install(None)


def coerce(plan: "FaultPlan | str | None") -> FaultPlan | None:
    if plan is None or isinstance(plan, FaultPlan):
        return plan
    return FaultPlan.parse(plan)


def active_plan() -> FaultPlan | None:
    """The installed plan, else one parsed from ``REPRO_FAULTS``.

    The env fallback is what carries a plan into build-worker processes:
    children inherit the environment, and the parse is cached per raw
    value so the dispatch-hot path stays one dict probe.
    """
    if _ACTIVE is not None:
        return _ACTIVE
    raw = os.environ.get(FAULTS_ENV, "")
    if not raw:
        return None
    global _ENV_CACHE
    if _ENV_CACHE is None or _ENV_CACHE[0] != raw:
        _ENV_CACHE = (raw, FaultPlan.parse(raw))
    return _ENV_CACHE[1]


@contextmanager
def scope(plan: FaultPlan | str | None):
    """Install a plan for a block, restoring the previous one after.

    ``scope(FaultPlan())`` (an empty plan) masks any ambient env plan —
    the way tests pin a fault-free baseline under a CI smoke plan.
    """
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = coerce(plan)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


@contextmanager
def suppressed(*seams: str):
    """Disable seams on this thread (e.g. the inline build fallback —
    the trusted final resort must not itself be injected)."""
    prev = getattr(_TLS, "sup", frozenset())
    _TLS.sup = prev | frozenset(seams)
    try:
        yield
    finally:
        _TLS.sup = prev


def _is_suppressed(seam: str) -> bool:
    return seam in getattr(_TLS, "sup", ())


def query(seam: str, **ctx) -> FaultSpec | None:
    """Ask the ambient plan whether this call should fault (no action)."""
    plan = active_plan()
    if plan is None or _is_suppressed(seam):
        return None
    return plan.query(seam, **ctx)


def maybe_fail(seam: str, **ctx) -> None:
    """Act out the ambient plan's decision at a code seam (no-op when no
    plan is active or the seam is suppressed on this thread)."""
    plan = active_plan()
    if plan is not None and not _is_suppressed(seam):
        plan.maybe_fail(seam, **ctx)
