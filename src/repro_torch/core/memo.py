"""Cross-candidate construction memoization (ROADMAP "memoization lever").

The offline search (paper Fig. 7) evaluates many (T-set, order, direction)
variants that share long placement prefixes: the same tasks get placed at
the same anchors onto grids that agree wherever it matters.  This module
memoizes that work at two granularities, both *outcome-exact* — a memo hit
returns precisely what the live search would have returned:

Pass level ("segment replay").  A whole PlaceTasksF/PlaceTasksB pass is a
deterministic function of (the id *set*, the direction, the grid content,
the grid extents): the heap pops tasks in a canonical order and every
anchor derives from already-committed placements.  Successful passes are
recorded as (final span, commit plan) under the key
(ids-digest, direction, space-digest, grid extent); re-reaching the key on
another branch replays the commits with zero searches.  The ids-digest is
the *sorted* id bytes — permuted-but-equal id sets are the same set and
must hit (place_pass heapifies, so its outcome is order-independent);
tests/test_memo.py locks that down.  Pass entries are scoped to one
sub-build: plans store task ids, and ids map to different demands in
different partitions, so ``attach`` clears them.

Place level ("windowed memo").  A single placement query is even more
reusable: an earliest-fit of demand v for k ticks from anchor a depends
only on the grid cells in [a, t0 + k) — every start it examined lives
there (mirrored for latest-fit).  Keying on a digest of just the
placements overlapping that window lets a query hit even when the grids
have long since diverged elsewhere (e.g. two candidate T-sets whose
placement traces share a prefix but end differently).  Entries store the
window bounds and its digest at record time; a lookup recomputes the
digest over the *current* placements and only trusts a bit-equal match.

Digests are 64-bit *additive* multiset hashes (sum mod 2^64) over
(machine, start, k, demand-bytes) quadruples — order-independent, O(1)
incremental under commit, O(dropped) under restore.  Addition, not XOR:
hashing the *demand* instead of the task id makes two identical tasks
legally sharing one (machine, start) slot hash-equal, and XOR would
cancel the pair into "empty window" (a real bug class caught by the
periodic workload); a sum accumulates multiplicity.  Dropping the task
id is what makes the digest a pure function of grid content: identical
window content yields identical digests no matter which tasks produced
it.
That is what lets one memo serve every partitioned sub-build of a DAG
(``build_schedule`` rebinds the memo to each partition's Space via
``attach``): task ids are partition-local, but a window whose content
digest matches is the same tick-space search problem regardless of
partition or even tick quantization, so cross-partition hits are exact.
The memo mirrors the Space's placement list through the Space observer
hook, so snapshot/restore keeps the digest exact.  A stale digest can
never validate: any content difference inside the window changes the sum
by a nonzero multiset of pseudo-random 64-bit terms (up to collision
odds, ~2^-64 per lookup pair).
"""

from __future__ import annotations

import threading

import numpy as np

from . import faults


class Counters:
    """Thread-safe accounting counters (``d[k]`` reads, ``add`` writes).

    The build service (core/buildsvc.py) runs builds concurrently, and a
    bare ``dict[k] += 1`` is a read-modify-write that drops increments
    under threads.  ``add`` is the one mutation path and takes the lock;
    plain ``[]`` reads stay lock-free (a torn read of an int cannot
    happen under CPython, and the benches only ever read quiescent or
    monotone values).
    """

    def __init__(self, names):
        self._lock = threading.Lock()
        self._d = dict.fromkeys(names, 0)

    def add(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._d[key] += n

    def __getitem__(self, key: str) -> int:
        return self._d[key]

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def reset(self) -> None:
        with self._lock:
            for k in self._d:
                self._d[k] = 0

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._d)


# counters threaded into benchmarks/bench_scheduling.py: the bench JSON
# reports placements-evaluated vs placements-memoized per scenario.
COUNTERS = Counters((
    "places_evaluated",      # live backend searches
    "places_memoized",       # windowed place-memo hits
    "places_memoized_xpart",  # ...of which hit an entry recorded by an
                              # earlier partition of the same DAG
    "passes_run",            # live place_pass executions
    "passes_replayed",       # pass-memo plan replays (incl. fail shortcuts)
    "variants_bound_skipped",  # order-variant subtrees pruned by bound
    "candidates_lb_skipped",   # candidates skipped at the tick LB
    "parts_reused",          # delta rebuild: partitions replayed from a
                             # previous build's content-keyed parts map
    "placements_reused",     # ...task placements those partitions carried
    "memo_discarded",        # entries failing their self-checksum on get
                             # (corruption -> treated as a miss, evicted)
))


def reset_counters() -> None:
    COUNTERS.reset()


def counters_snapshot() -> dict[str, int]:
    return COUNTERS.snapshot()


_M1 = 0x9E3779B97F4A7C15
_M2 = 0xC2B2AE3D27D4EB4F
_M3 = 0x165667B19E3779F9
_MASK = (1 << 64) - 1


def item_hash(a: int, b: int, c: int, salt: int = 0) -> int:
    """64-bit mix of one placement tuple (xorshift-multiply finalizer).

    The memo feeds it (machine, start, k) with the demand-row hash as
    ``salt``; every component perturbs the result.
    """
    h = (a * _M1 ^ (b + 7) * _M2 ^ (c & _MASK) * _M3 ^ (salt & _MASK)) & _MASK
    h ^= h >> 29
    h = (h * _M1) & _MASK
    h ^= h >> 32
    return h


def _place_chk(b0: int, b1: int, dig: int, m: int, t0: int,
               epoch: int) -> int:
    """Self-checksum of one place-memo entry (fault hardening: a stored
    entry whose fields no longer hash to this is discarded on get)."""
    return item_hash(b0 * 1000003 + b1, m * 1000003 + t0, epoch, salt=dig)


def _pass_chk(span: int, plan: list) -> int:
    """Self-checksum of one pass-memo entry (order-sensitive over the
    replay plan: any mutated commit flips it)."""
    h = item_hash(span, len(plan), 0)
    for i, (t, m, t0) in enumerate(plan):
        h = (h + item_hash(t * 1000003 + m, t0, i, salt=h)) & _MASK
    return h


#: per (direction, demand, k, anchor) key, how many distinct grid-window
#: contexts to remember before dropping the oldest
PLACE_ENTRY_CAP = 8


class ConstructionMemo:
    """Placement memo for one builder DAG (see module docstring).

    ``attach`` binds it to a Space (registering as a Space observer so
    commits/restores keep the mirrored (start, end, hash) arrays and the
    whole-content digest exact) and may be called again for each
    partitioned sub-build: the windowed place memo persists across
    partitions (content-addressed, see module docstring), the pass memo
    and the placement mirror reset.
    """

    def __init__(self, space=None):
        self.space = None
        cap = 256
        self._start = np.zeros(cap, dtype=np.int64)
        self._end = np.zeros(cap, dtype=np.int64)
        self._hash = np.zeros(cap, dtype=np.uint64)
        self._n = 0
        self.ckey = 0                       # sum (mod 2^64) over live placements
        self._place: dict[tuple, list] = {}
        self._pass: dict[tuple, tuple] = {}
        self._epoch = 0                     # bumped per attach (partition)
        if space is not None:
            self.attach(space)

    def attach(self, space) -> None:
        """(Re)bind to a Space: fresh mirror + pass memo, kept place memo."""
        if self.space is not None:
            self.space.remove_observer(self)
        self.space = space
        space.add_observer(self)
        self._n = 0
        self.ckey = 0
        self._pass.clear()
        self._epoch += 1

    # -- Space.observer protocol ---------------------------------------
    def on_commit(self, task: int, machine: int, start: int, k: int,
                  v: np.ndarray) -> None:
        n = self._n
        if n == len(self._start):
            grow = 2 * n
            self._start = np.resize(self._start, grow)
            self._end = np.resize(self._end, grow)
            self._hash = np.resize(self._hash, grow)
        # item_hash inlined: this runs once per grid commit.  The hash
        # covers (machine, start, k, demand) — task ids are NOT part of it,
        # so the digest identifies grid *content* (what commit subtracts),
        # which is what makes cross-partition place-memo hits sound.
        salt = hash(v.tobytes())
        h = (machine * _M1 ^ (start + 7) * _M2 ^ (k & _MASK) * _M3
             ^ (salt & _MASK)) & _MASK
        h ^= h >> 29
        h = (h * _M1) & _MASK
        h ^= h >> 32
        self._start[n] = start
        self._end[n] = start + k
        self._hash[n] = h
        self._n = n + 1
        self.ckey = (self.ckey + h) & _MASK

    def on_restore(self, n_placed: int, lo=None, hi=None) -> None:
        if n_placed < self._n:
            dropped = int(np.sum(self._hash[n_placed:self._n],
                                 dtype=np.uint64))
            self.ckey = (self.ckey - dropped) & _MASK
        self._n = n_placed

    # -- windowed place memo -------------------------------------------
    def _window_digest(self, a: int, b: int) -> int:
        """Sum (mod 2^64) over placements intersecting logical [a, b)."""
        n = self._n
        if n == 0:
            return 0
        mask = (self._end[:n] > a) & (self._start[:n] < b)
        if not mask.any():
            return 0
        return int(np.sum(self._hash[:n][mask], dtype=np.uint64))

    def place_get(self, direction: str, vb: bytes, k: int,
                  anchor: int) -> tuple[int, int] | None:
        lst = self._place.get((direction, vb, k, anchor))
        if not lst:
            return None
        fault = faults.query("memo", op="place", k=int(k), anchor=int(anchor))
        if fault is not None and lst:
            if fault.kind == "drop":          # eviction: whole key gone
                lst.clear()
                return None
            if fault.kind == "corrupt":       # flip a stored field, not chk
                b0, b1, dig, m, t0, epoch, chk = lst[-1]
                lst[-1] = (b0, b1, dig, m, t0 + 1, epoch, chk)
        live = []
        hit = None
        for e in lst:
            b0, b1, dig, m, t0, epoch, chk = e
            if chk != _place_chk(b0, b1, dig, m, t0, epoch):
                # bit-rot / injected corruption: the entry is evicted and
                # the lookup falls through to the live search — a bad
                # entry can cost a rebuild, never a mis-placement
                COUNTERS.add("memo_discarded")
                continue
            live.append(e)
            if hit is None and self._window_digest(b0, b1) == dig:
                COUNTERS.add("places_memoized")
                if epoch != self._epoch:
                    COUNTERS.add("places_memoized_xpart")
                hit = (m, t0)
        if len(live) != len(lst):
            lst[:] = live
        return hit

    def place_put(self, direction: str, vb: bytes, k: int, anchor: int,
                  forward: bool, m: int, t0: int) -> None:
        # the cells the live search examined: every candidate start it
        # rejected plus the slot it took (see module docstring)
        b0, b1 = (anchor, t0 + k) if forward else (t0, anchor)
        lst = self._place.setdefault((direction, vb, k, anchor), [])
        dig = self._window_digest(b0, b1)
        lst.append((b0, b1, dig, m, t0, self._epoch,
                    _place_chk(b0, b1, dig, m, t0, self._epoch)))
        if len(lst) > PLACE_ENTRY_CAP:
            del lst[0]

    # -- pass-level segment memo ---------------------------------------
    def pass_key(self, ids: np.ndarray, direction: str) -> tuple:
        sp = self.space
        return (np.sort(ids).tobytes(), direction, self.ckey, sp.T, sp.off)

    def pass_get(self, key: tuple):
        ent = self._pass.get(key)
        if ent is None:
            return None
        span, plan, chk = ent
        fault = faults.query("memo", op="pass", n=len(plan))
        if fault is not None:
            if fault.kind == "drop":
                del self._pass[key]
                return None
            if fault.kind == "corrupt" and plan:
                t, m, t0 = plan[0]
                plan = [(t, m + 1, t0)] + plan[1:]
                self._pass[key] = (span, plan, chk)
        if chk != _pass_chk(span, plan):
            COUNTERS.add("memo_discarded")
            del self._pass[key]
            return None
        return span, plan

    def pass_put(self, key: tuple, span: int, plan: list) -> None:
        self._pass[key] = (span, plan, _pass_chk(span, plan))
