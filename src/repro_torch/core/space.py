"""Virtual resource-time space (paper §3, §4.2).

The space has d+1 dimensions: d resources x time.  We discretize time into
ticks and model `m` machines each with capacity 1.0 per resource, so a task
placement is (machine, start_tick) with its demand subtracted over
[start, start + dur_ticks).

Coordinates handed to callers are *logical* ticks and may be negative
(backward placement packs tasks before the anchor).  Physically the grid is
a finite array with an origin offset; it grows on demand at either end —
which is what makes placement dead-end-free (§4.3 then only has to argue
about dependency consistency, never about running out of room).

Placement primitives:
  * earliest_fit(v, k, ready)  — forward placement (§4.2)
  * latest_fit(v, k, deadline) — backward placement (§4.2)

Both use a cumulative-sum trick to find runs of >=k feasible ticks in
O(m*T) numpy work.  The `hint` of a previous placement of an identical task
is a sound floor/ceiling for the search (the space only fills up within a
pass), which makes placing a whole stage ~O(T) amortized.

The engine layer (core/engine/) supplies alternative search strategies
over this grid; `snapshot`/`restore` give the builder copy-on-write-style
variant evaluation: a snapshot costs O(1), a restore costs O(cells
written since), never O(grid).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def runs_of_k(ok: np.ndarray, k: int) -> np.ndarray:
    """Per row of boolean `ok` (m, L): positions starting a run of >= k Trues.

    Returns (m, L - k + 1) for k > 1 (positions whose run would overflow L
    are dropped), `ok` itself for k == 1.  The cumulative-sum trick shared
    by every feasibility scan in the repo — reference, chunked, batched.
    """
    if k <= 1:
        return ok
    if ok.shape[1] < k:     # window shorter than the run: nothing can start
        return np.zeros((ok.shape[0], 0), dtype=bool)
    c = np.cumsum(ok, axis=1, dtype=np.int32)
    runs = c[:, k - 1 :].copy()
    runs[:, 1:] -= c[:, : runs.shape[1] - 1]
    return runs == k


@dataclasses.dataclass
class Placement:
    task: int
    machine: int
    start: int   # logical tick
    end: int     # logical tick (exclusive)


@dataclasses.dataclass(frozen=True)
class SpaceSnapshot:
    """O(1) checkpoint of a Space; see Space.snapshot/restore."""

    n_undo: int
    n_placed: int
    min_start: int | None
    max_end: int | None
    T: int
    off: int


class Space:
    def __init__(self, m: int, d: int, horizon: int, tick: float = 1.0):
        self.m = int(m)
        self.d = int(d)
        self.tick = float(tick)
        self.T = int(max(horizon, 8))        # physical grid length
        self.off = 0                          # physical = logical + off
        self.avail = np.ones((self.m, self.T, self.d), dtype=np.float32)
        self.placements: list[Placement] = []
        self._min_start: int | None = None   # logical
        self._max_end: int | None = None     # logical
        # bumped whenever capacity changes; engine sessions use it to decide
        # whether a cached feasibility bitmap is still exact or merely a
        # sound upper bound needing a live recheck.
        self.version = 0
        # undo log for snapshot/restore: (machine, logical start, pre-commit
        # copy of the overwritten cells) — restoring copies the exact bits
        # back, so rollback is float-exact (no subtract/re-add drift).
        self._undo: list[tuple[int, int, np.ndarray]] = []
        # optional mirrors of the grid/placement state.  Each observer gets
        #   on_commit(task, machine, start, k, v)    after every commit
        #   on_restore(n_placed, lo, hi)             after every restore,
        # where [lo, hi) is the logical tick range whose cell values were
        # rewritten (None/None when nothing was undone).  core/memo.py keeps
        # its content digests exact through these; a device-resident
        # grid mirror can stay in sync the same way.
        self.observers: list = []

    # ------------------------------------------------------------------
    def add_observer(self, obs) -> None:
        if obs not in self.observers:
            self.observers.append(obs)

    def remove_observer(self, obs) -> None:
        if obs in self.observers:
            self.observers.remove(obs)

    # ------------------------------------------------------------------
    def clone(self) -> "Space":
        s = Space.__new__(Space)
        s.observers = []       # mirrors track ONE space; clones start fresh
        s.version = self.version
        s.m, s.d, s.tick, s.T, s.off = self.m, self.d, self.tick, self.T, self.off
        s.avail = self.avail.copy()
        s.placements = list(self.placements)
        s._min_start = self._min_start
        s._max_end = self._max_end
        s._undo = list(self._undo)
        return s

    # -- logical extent --------------------------------------------------
    @property
    def grid_start(self) -> int:
        """Lowest logical tick inside the physical grid."""
        return -self.off

    @property
    def grid_end(self) -> int:
        """One past the highest logical tick inside the physical grid."""
        return self.T - self.off

    # -- copy-on-write-style variant evaluation --------------------------
    def snapshot(self) -> SpaceSnapshot:
        """O(1) checkpoint; restore() rolls back everything committed since."""
        return SpaceSnapshot(len(self._undo), len(self.placements),
                             self._min_start, self._max_end, self.T, self.off)

    def restore(self, snap: SpaceSnapshot, keep_extent: bool = False) -> None:
        """Roll back to `snap`: O(cells written since), plus one grid slice
        if the grid grew (what a clone would have paid anyway).

        Shrinking back matters: a kept-grown grid would push the empty-grid
        backward deadline (grid_end) further out on every candidate variant,
        snowballing the grid and the scans over it.  ``keep_extent`` skips
        the shrink — needed when commits recorded after the snapshot will be
        replayed into the (possibly grown) region right away.
        """
        lo = hi = None   # logical range of rewritten cells, for observers
        for machine, start, vals in reversed(self._undo[snap.n_undo:]):
            ps = start + self.off
            self.avail[machine, ps : ps + len(vals), :] = vals
            if lo is None or start < lo:
                lo = start
            if hi is None or start + len(vals) > hi:
                hi = start + len(vals)
        del self._undo[snap.n_undo:]
        del self.placements[snap.n_placed:]
        self.version += 1
        if not keep_extent and (self.T != snap.T or self.off != snap.off):
            shift = self.off - snap.off  # growth only ever extends, off >= snap.off
            self.avail = np.ascontiguousarray(self.avail[:, shift : shift + snap.T, :])
            self.T, self.off = snap.T, snap.off
        for obs in self.observers:
            obs.on_restore(snap.n_placed, lo, hi)
        self._min_start = snap.min_start
        self._max_end = snap.max_end

    def _grow_back(self) -> None:
        extra = np.ones((self.m, self.T, self.d), dtype=np.float32)
        self.avail = np.concatenate([self.avail, extra], axis=1)
        self.T = self.avail.shape[1]

    def _grow_front(self) -> None:
        grow = self.T
        extra = np.ones((self.m, grow, self.d), dtype=np.float32)
        self.avail = np.concatenate([extra, self.avail], axis=1)
        self.off += grow
        self.T = self.avail.shape[1]

    # ------------------------------------------------------------------
    def _fit_starts(self, v: np.ndarray, k: int, lo: int, hi: int):
        """All (machine, logical t) fitting v over [t, t+k), lo <= t <= hi-k.

        lo/hi are logical; caller guarantees they map inside the grid.
        """
        plo, phi = lo + self.off, hi + self.off
        ok = (self.avail[:, plo:phi, :] >= v).all(axis=2)  # (m, phi-plo)
        ms, ts = np.nonzero(runs_of_k(ok, k))
        return ms, ts + lo

    def fit_first(self, v: np.ndarray, k: int, lo: int, hi: int,
                  latest: bool = False) -> tuple[int, int] | None:
        """Extreme (machine, t) fitting v over [t, t+k) with lo <= t <= hi.

        Like one `_fit_starts` query restricted to starts in [lo, hi], but
        scanned in chunks from the near end with early exit — the engine's
        live searches almost always hit within the first chunk.  Returns
        the lexicographic extreme the full scan would return: (min t, min
        machine), or (max t, min machine) when ``latest``.
        """
        if hi < lo:
            return None
        chunk = max(64, k)

        def _scan_chunk(c0: int, c1: int):
            # starts c0..c1 need avail rows [c0, c1 + k); slicing clips at
            # the grid edge, which correctly truncates (and excludes) runs
            # that would overflow it
            ok = (self.avail[:, c0 + self.off : c1 + k + self.off, :] >= v).all(axis=2)
            good = runs_of_k(ok, k)[:, : c1 - c0 + 1]
            if not good.any():
                return None
            ms, ts = np.nonzero(good)
            tx = int(ts.max()) if latest else int(ts.min())
            return int(ms[ts == tx].min()), tx + c0

        if latest:
            c1 = hi
            while c1 >= lo:
                c0 = max(lo, c1 - chunk + 1)
                res = _scan_chunk(c0, c1)
                if res is not None:
                    return res
                c1 = c0 - 1
        else:
            c0 = lo
            while c0 <= hi:
                c1 = min(hi, c0 + chunk - 1)
                res = _scan_chunk(c0, c1)
                if res is not None:
                    return res
                c0 = c1 + 1
        return None

    def check_fit_at(self, v: np.ndarray, k: int, t: int) -> int:
        """Lowest machine fitting v over [t, t+k) at logical t, else -1."""
        pt = t + self.off
        if pt < 0 or pt + k > self.T:
            return -1
        ok = (self.avail[:, pt : pt + k, :] >= v).all(axis=(1, 2))
        return int(np.argmax(ok)) if ok.any() else -1

    _check_at = check_fit_at

    def check_fit_exact(self, machine: int, t: int, k: int, v: np.ndarray) -> bool:
        """Does v fit on `machine` over logical [t, t+k) right now?"""
        pt = t + self.off
        if pt < 0 or pt + k > self.T:
            return False
        return bool((self.avail[machine, pt : pt + k, :] >= v).all())

    def earliest_fit(self, v: np.ndarray, k: int, ready: int,
                     hint: tuple[int, int] | None = None) -> tuple[int, int]:
        """Earliest (machine, logical start >= ready) fitting v for k ticks."""
        k = max(int(k), 1)
        lo = int(ready)
        if hint is not None and hint[1] >= ready:
            lo = max(lo, hint[1])
            m = self._check_at(v, k, hint[1])
            if m >= 0:
                return m, hint[1]
        while True:
            if lo + self.off < 0:
                self._grow_front()
                continue
            if lo + self.off + k > self.T:
                self._grow_back()
                continue
            hi = self.T - self.off  # logical end of grid
            ms, ts = self._fit_starts(v, k, lo, hi)
            if len(ts):
                j = int(np.argmin(ts))
                return int(ms[j]), int(ts[j])
            self._grow_back()

    def latest_fit(self, v: np.ndarray, k: int, deadline: int,
                   hint: tuple[int, int] | None = None) -> tuple[int, int]:
        """Latest (machine, logical start) with start + k <= deadline fitting v."""
        k = max(int(k), 1)
        hi = int(deadline)
        if hint is not None and hint[1] + k <= deadline:
            hi = min(hi, hint[1] + k)
            m = self._check_at(v, k, hint[1])
            if m >= 0:
                return m, hint[1]
        while True:
            if hi + self.off > self.T:
                self._grow_back()
                continue
            lo = -self.off  # logical start of grid
            if hi - k < lo:
                self._grow_front()
                continue
            ms, ts = self._fit_starts(v, k, lo, hi)
            if len(ts):
                j = int(np.argmax(ts))
                return int(ms[j]), int(ts[j])
            self._grow_front()

    # ------------------------------------------------------------------
    def commit(self, task: int, machine: int, start: int, k: int, v: np.ndarray,
               check: bool = True) -> Placement:
        """Subtract v over [start, start+k) on `machine` and log the undo.

        ``check=False`` skips the over-commit guard: replay paths (memo
        plan replays, place_best winner replays) re-commit placements that
        already passed the guard against bit-identical window content.
        """
        k = max(int(k), 1)
        ps = start + self.off
        assert 0 <= ps and ps + k <= self.T, "commit outside grid"
        win = self.avail[machine, ps : ps + k, :]   # one view, three uses
        self._undo.append((machine, start, win.copy()))
        win -= v
        self.version += 1
        if check and win.min() < -1e-5:
            raise RuntimeError("over-committed space")
        p = Placement(task, machine, start, start + k)
        self.placements.append(p)
        for obs in self.observers:
            obs.on_commit(task, machine, start, k, v)
        self._min_start = start if self._min_start is None else min(self._min_start, start)
        self._max_end = start + k if self._max_end is None else max(self._max_end, start + k)
        return p

    # ------------------------------------------------------------------
    @property
    def makespan_ticks(self) -> int:
        if self._min_start is None:
            return 0
        return self._max_end - self._min_start

    @property
    def makespan(self) -> float:
        return self.makespan_ticks * self.tick

    def utilization(self) -> float:
        """Fraction of resource-time used inside the occupied span."""
        if self._min_start is None:
            return 0.0
        window = self.avail[:, self._min_start + self.off : self._max_end + self.off, :]
        return float(1.0 - window.mean())
