"""Batched placement backend: candidate-parallel windowed feasibility.

Instead of rescanning the grid per task, a pass-scoped session answers a
whole ready-set at once: one `scan_starts` call lifts the cumsum
run-length trick from (m, T) to (n_tasks, m, W) over an adaptive window
and yields, per task, the bitmap of (start, machine) slots where it fits.

Exactness argument.  Capacity only decreases within a placement pass
(commits subtract; rollbacks happen only between passes), so a bitmap
scanned at grid version V is a sound *superset* of live feasibility at
any later version: a clear bit can never become placeable again.  The
walk therefore:

  * trusts the bitmap outright while the grid version still matches
    (bits are exact — nothing committed since the scan);
  * otherwise verifies the first candidate bit with one O(dur * d) live
    recheck, and on a stale hit settles the whole window with a single
    live (m, W) mini-scan — sound because everything lexicographically
    before that bit was already clear in the superset.

Walking bits in (start, machine) lexicographic order — mirrored for
backward passes — thus reproduces the reference backend's
earliest/latest-fit results tick-for-tick, including the hint fast path,
while doing ~one tensor scan per ready-set instead of one full-grid scan
per task.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from . import kernels
from .base import (BACKWARD, FORWARD, HintKey, PeerTask, PlacementBackend,
                   PlacementSession, ceil32, register_backend)
from .kernels import scan_starts  # noqa: F401  (re-exported; moved to kernels)

#: first window size in ticks (doubles on every extension); sized so the
#: common case — placing near the packing frontier — resolves in one scan
WINDOW0 = 192
#: max ready-set peers prefetched into one scan
MAX_BATCH = 32
#: durations above this skip the bitmap machinery: a long task's window is
#: duration-dominated, so batching it multiplies large scans that a couple
#: of chunked live probes (Space.fit_first) answer outright.  Long stages
#: are also narrow (few tasks), so there is no cohort to amortize over.
#: Shared with the dispatch layer, whose compiled-scan shape buckets lean
#: on every bitmap-path duration being <= LONG_K.
LONG_K = kernels.LONG_K


class _Cand:
    """One scanned window's bitmap for one task.

    The bitmap may be *lazy*: a backend that scans asynchronously (a
    device-resident session) hands a loader instead of the flat
    array, and the first ``next_bit`` call materializes it.  The bitmap's
    *content* is fixed at scan time either way — an async launch computes
    over the grid state captured at the call — so version/edge soundness
    reasoning is untouched by when the bits arrive on the host.
    """

    __slots__ = ("wlo", "whi", "flat", "reverse", "version", "edge", "_load")

    def __init__(self, wlo: int, whi: int, flat: np.ndarray | None,
                 reverse: bool, version: int, edge: int, load=None):
        self.wlo = wlo          # lowest logical start covered
        self.whi = whi          # highest logical start covered (inclusive)
        self.flat = flat        # (W * m,) bool in walk order, or None (lazy)
        self.reverse = reverse
        self.version = version  # grid version at scan time
        # logical grid_end at scan time: starts above edge - dur had their
        # runs truncated by the grid boundary and were cleared UNSOUNDLY
        # with respect to later growth — they are NOT settled by this
        # bitmap and must be rescanned once the grid grows
        self.edge = edge
        self._load = load

    def next_bit(self, m: int, bound: int):
        """First set bit in walk order at/after ``bound`` → (machine, t)."""
        flat = self.flat
        if flat is None:
            flat = self.flat = self._load()
            self._load = None
        j0 = ((self.whi - bound) if self.reverse else (bound - self.wlo)) * m
        if j0 < 0:
            j0 = 0
        elif j0 >= flat.size:
            return None
        j = j0 + int(np.argmax(flat[j0:]))
        if not flat[j]:
            return None
        t = (self.whi - j // m) if self.reverse else (self.wlo + j // m)
        return j % m, t


#: sentinel start returned when every admissible slot is past the prune cap
PRUNED = -1


class BatchedSession(PlacementSession):
    wants_peers = True
    wants_f32 = True

    def __init__(self, space, direction: str, backend: "BatchedBackend"):
        super().__init__(space, direction)
        self._backend = backend
        self._cands: dict[int, _Cand] = {}

    # ------------------------------------------------------------------
    def place(
        self,
        tid: int,
        v: np.ndarray,
        k: int,
        anchor: int,
        key: HintKey,
        peers_fn: Callable[[], Sequence[PeerTask]] | None = None,
        cap: int | None = None,
    ) -> tuple[int, int]:
        sp = self.space
        h = self.hint.get(key)
        # compare in pure float32 (no grid-slice promotion); ceil32 keeps
        # every comparison bit-identical to the reference float64 one
        v = ceil32(v)
        if self.direction == FORWARD:
            lo = int(anchor)
            if cap is not None and lo >= cap:
                return PRUNED, cap  # even the anchor is past the prune bound
            if h is not None and h[1] >= anchor:
                if cap is not None and h[1] >= cap:
                    return PRUNED, cap
                lo = max(lo, h[1])
                mm = sp.check_fit_at(v, k, h[1])
                if mm >= 0:
                    self.hint[key] = (mm, h[1])
                    return mm, h[1]
            # mirror the reference pre-scan growth so grid extents (and the
            # deadline of later unanchored backward tasks) stay identical
            while lo < sp.grid_start:
                sp._grow_front()
            res = self._resolve_fwd(tid, v, k, lo, peers_fn, cap)
        else:
            deadline = int(anchor)
            while deadline > sp.grid_end:
                sp._grow_back()
            hi = deadline
            if cap is not None and hi - k <= cap:
                return PRUNED, cap  # even the deadline slot is past the bound
            if h is not None and h[1] + k <= deadline:
                if cap is not None and h[1] <= cap:
                    return PRUNED, cap
                hi = min(hi, h[1] + k)
                mm = sp.check_fit_at(v, k, h[1])
                if mm >= 0:
                    self.hint[key] = (mm, h[1])
                    return mm, h[1]
            res = self._resolve_bwd(tid, v, k, hi - k, peers_fn, cap)
        if res[0] >= 0:
            self.hint[key] = res
        return res

    # ------------------------------------------------------------------
    def _consume(self, cand: _Cand, v, k, bound):
        """Extreme live slot inside one window, or None if the window is dry.

        ``bound`` clips the walk (lowest admissible start forward, highest
        backward).  At most one live mini-scan per call: the grid is frozen
        during a `place`, so its result is definitive for the window.
        """
        sp = self.space
        nxt = cand.next_bit(sp.m, bound)
        if nxt is None:
            return None
        mm, t = nxt
        if cand.version == sp.version or sp.check_fit_exact(mm, t, k, v):
            return mm, t
        # stale hit: everything in walk order before (t, mm) was clear even
        # in the superset, so one live scan of [t .. window edge] decides.
        if cand.reverse:
            return sp.fit_first(v, k, cand.wlo, t, latest=True)
        return sp.fit_first(v, k, t, cand.whi, latest=False)

    def _resolve_fwd(self, tid, v, k, lo, peers_fn, cap=None):
        sp = self.space
        hi_cap = None if cap is None else cap - 1   # highest admissible start
        if k > LONG_K:
            cur = lo
            while True:
                top = sp.grid_end - k
                if hi_cap is not None:
                    top = min(top, hi_cap)
                res = sp.fit_first(v, k, cur, top)
                if res is not None:
                    return res
                if hi_cap is not None and top >= hi_cap:
                    return PRUNED, cap   # every admissible start proven dry
                nxt = sp.grid_end - k + 1  # everything below is now dry
                sp._grow_back()
                cur = max(lo, nxt)
        cur = lo
        cand = self._cands.pop(tid, None)
        if cand is not None and cand.wlo <= lo:
            res = self._consume(cand, v, k, lo)
            if res is not None:
                # this IS the earliest fit; past the cap it only proves
                # the pass is doomed
                if hi_cap is not None and res[1] > hi_cap:
                    return PRUNED, cap
                return res
            # starts above cand.edge - k had their runs truncated by the
            # then-grid boundary: not settled, resume from there
            cur = max(lo, min(cand.whi, cand.edge - k) + 1)
        W = max(WINDOW0, 2 * k)
        while True:
            if hi_cap is not None and cur > hi_cap:
                return PRUNED, cap
            if cur > sp.grid_end - k:
                sp._grow_back()
            whi = min(cur + W - 1, sp.grid_end - 1)
            if hi_cap is not None:
                whi = min(whi, hi_cap)
            if whi < cur:
                sp._grow_back()
                continue
            cand = self._scan(tid, v, k, cur, whi, peers_fn)
            res = self._consume(cand, v, k, cur)  # fresh scan: bits exact
            if res is not None:
                return res
            # same truncation rule for the window just scanned: anything in
            # (grid_end - k, whi] is only proven dry for the CURRENT grid
            cur = min(whi, sp.grid_end - k) + 1
            W *= 2
            peers_fn = None  # prefetch only on the first window of a call

    def _resolve_bwd(self, tid, v, k, hi_start, peers_fn, cap=None):
        sp = self.space
        lo_cap = None if cap is None else cap + 1   # lowest admissible start
        if k > LONG_K:
            cur = hi_start
            while True:
                bot = sp.grid_start
                if lo_cap is not None:
                    bot = max(bot, lo_cap)
                res = sp.fit_first(v, k, bot, cur, latest=True)
                if res is not None:
                    return res
                if lo_cap is not None and bot <= lo_cap:
                    return PRUNED, cap
                nxt = sp.grid_start - 1
                sp._grow_front()
                cur = min(hi_start, nxt)
        cur = hi_start
        cand = self._cands.pop(tid, None)
        if cand is not None and cand.whi >= hi_start:
            # starts above cand.edge - k had their runs truncated by the
            # then-grid boundary, so their cleared bits are unsound once the
            # deadline has grown the grid (mirror of the forward resume
            # rule): settle that top region with a live scan first
            safe_hi = min(hi_start, cand.edge - k)
            if safe_hi < hi_start:
                res = sp.fit_first(v, k, safe_hi + 1, hi_start, latest=True)
                if res is not None:
                    if lo_cap is not None and res[1] < lo_cap:
                        return PRUNED, cap
                    return res
            if safe_hi >= cand.wlo:
                res = self._consume(cand, v, k, safe_hi)
                if res is not None:
                    if lo_cap is not None and res[1] < lo_cap:
                        return PRUNED, cap
                    return res
            cur = min(hi_start, cand.wlo - 1)
        W = max(WINDOW0, 2 * k)
        while True:
            if lo_cap is not None and cur < lo_cap:
                return PRUNED, cap
            while cur < sp.grid_start:
                sp._grow_front()
            wlo = max(cur - W + 1, sp.grid_start)
            if lo_cap is not None:
                wlo = max(wlo, lo_cap)
            cand = self._scan(tid, v, k, wlo, cur, peers_fn)
            res = self._consume(cand, v, k, cur)
            if res is not None:
                return res
            if lo_cap is not None and wlo <= lo_cap:
                return PRUNED, cap
            if wlo <= sp.grid_start:
                # the whole grid below the deadline is dry — like
                # latest_fit, expose free space before the origin
                sp._grow_front()
            cur = wlo - 1
            W *= 2
            peers_fn = None

    # ------------------------------------------------------------------
    def _scan(self, tid, v, k, wlo, whi, peers_fn) -> _Cand:
        """Scan starts [wlo, whi] for ``tid`` plus prefetchable peers."""
        sp = self.space
        reverse = self.direction == BACKWARD
        batch = [(tid, v, k)]
        if peers_fn is not None:
            for p in peers_fn():
                if len(batch) > MAX_BATCH:
                    break
                if p.tid == tid or p.tid in self._cands or p.dur_ticks > LONG_K:
                    continue
                # only worth caching when the peer's own walk would start
                # inside this window — a cache that misses the peer's first
                # admissible start is discarded at use (estimates are hints;
                # the walk re-clips against the real pop-time anchor)
                if reverse:
                    start = p.anchor - p.dur_ticks   # highest admissible start
                    usable = wlo <= start <= whi
                else:
                    usable = wlo <= p.anchor <= whi
                if usable:
                    batch.append((p.tid, p.demand, p.dur_ticks))
        Vs = ceil32(np.stack([b[1] for b in batch]))
        ks = np.array([b[2] for b in batch], dtype=np.int64)
        plo, phi = wlo + sp.off, whi + 1 + sp.off
        goods = self._backend.scan_kernel(sp, Vs, ks, plo, phi, reverse)
        out: _Cand | None = None
        ver, edge = sp.version, sp.grid_end
        eager = isinstance(goods, np.ndarray)
        for i, (btid, _bv, _bk) in enumerate(batch):
            if eager:
                c = _Cand(wlo, whi, np.ascontiguousarray(goods[i]), reverse,
                          ver, edge)
            else:   # async backend: rows materialize on first use
                c = _Cand(wlo, whi, None, reverse, ver, edge, load=goods[i])
            if btid == tid:
                out = c
            else:
                self._cands[btid] = c
        assert out is not None
        return out


class BatchedBackend(PlacementBackend):
    name = "batched"
    wants_prescan = True

    def scan_kernel(self, space, Vs, ks, plo, phi, reverse):
        """The feasibility-scan kernel, routed through the kernel-dispatch
        layer (core/engine/kernels.py).  A device-resident backend
        overrides it with a session keyed off the Space — which is why
        the entry point takes the Space, not a bare grid array."""
        return kernels.scan(space.avail, Vs, ks, plo, phi, reverse)

    def session(self, space, direction: str) -> BatchedSession:
        return BatchedSession(space, direction, self)

    def sessions(self, space, specs) -> list[BatchedSession]:
        """Multi-variant entry: stack sibling variants' first feasibility
        scans into one pass per direction over the shared node grid.

        All sibling branches start from exactly this grid state, so one
        (n_variants * n_tasks, m, W) scan is sound for every branch: a
        branch only subtracts capacity from the scanned state, keeping
        each bitmap a superset that the session's stale-walk settles with
        live rechecks (same argument as per-pass peer prefetch — the
        prescan can change cost, never results).
        """
        out = [self.session(space, d) for d, _peers in specs]
        for reverse in (False, True):
            direction = BACKWARD if reverse else FORWARD
            batch: list[tuple[int, np.ndarray, int, int]] = []   # tid, v, k, first start
            owners: list[list[BatchedSession]] = []
            tids: dict[int, int] = {}
            for sess, (d, peers) in zip(out, specs):
                if d != direction:
                    continue
                for p in peers:
                    if p.dur_ticks > LONG_K:
                        continue
                    if p.tid in tids:    # same task in two sibling branches
                        owners[tids[p.tid]].append(sess)
                        continue
                    tids[p.tid] = len(batch)
                    start = p.anchor - p.dur_ticks if reverse else p.anchor
                    batch.append((p.tid, p.demand, p.dur_ticks, start))
                    owners.append([sess])
            if not batch:
                continue
            kmax = max(k for _t, _v, k, _s in batch)
            if reverse:
                whi = max(s for _t, _v, _k, s in batch)
                wlo = max(whi - max(WINDOW0, 2 * kmax) + 1, space.grid_start)
            else:
                wlo = min(s for _t, _v, _k, s in batch)
                whi = min(wlo + max(WINDOW0, 2 * kmax) - 1, space.grid_end - 1)
            if whi < wlo:
                continue
            # keep only peers whose own walk starts inside the window (a
            # cache missing a task's first admissible start is discarded
            # at use, so scanning it would be waste)
            keep = [j for j, (_t, _v, _k, s) in enumerate(batch)
                    if wlo <= s <= whi]
            if not keep:
                continue
            Vs = ceil32(np.stack([batch[j][1] for j in keep]))
            ks = np.array([batch[j][2] for j in keep], dtype=np.int64)
            plo, phi = wlo + space.off, whi + 1 + space.off
            goods = self.scan_kernel(space, Vs, ks, plo, phi, reverse)
            ver, edge = space.version, space.grid_end
            eager = isinstance(goods, np.ndarray)
            for i, j in enumerate(keep):
                if eager:
                    cand = _Cand(wlo, whi, np.ascontiguousarray(goods[i]),
                                 reverse, ver, edge)
                else:
                    cand = _Cand(wlo, whi, None, reverse, ver, edge,
                                 load=goods[i])
                for sess in owners[j]:
                    # the _Cand is read-only; sibling sessions may share it
                    sess._cands[batch[j][0]] = cand
        return out


register_backend("batched", BatchedBackend)
