"""Device-resident placement sessions behind the ``jit`` backend flag.

Same placement semantics as the batched backend — only the window scan
runs against a *persistent mirror* of the Space's grid on the session's
device:

  * the mirror (`DeviceGrid`, a float32 ``(m, Tb, d)`` tensor) registers
    as a Space observer, so every ``commit`` and ``restore`` marks the
    touched tick range dirty instead of re-uploading the window per scan;
  * before a scan, only the dirty or never-synced slab goes up: on the
    card one pinned host-to-device copy (``ps_copy_slab``) on the stream
    the scans run on;
  * the scan reads its window in place out of the mirror
    (``kernel.scan_resident``, ``ps_scan_resident``) and returns without
    waiting; `_DeviceRows` waits on the launch's event when its first row
    is read, and never before;
  * small batches (below ``min_device_g()`` rows) and the row the session
    walks at once go through the dispatch layer (``kernels.scan``: on a
    card the staged CUDA call, on the CPU the plain version) —
    outcome-identical by construction (all scan implementations are
    bit-equal).

CUDA has no compile cache to bound and needs no shape buckets: a scan
launches at its live shape.  The buffer length ``Tb`` grows geometrically
(a power of two, twice the span it must hold) when a window passes it;
reallocations and uploaded bytes are counted in ``PROFILE``.

A launch sees the grid as it was at launch.  JAX arrays are immutable;
CUDA buffers are not, so that is kept by ordering: every mirror made on a
thread uploads and scans on that thread's stream (``kernel.resident_stage``),
so a later slab upload runs after every scan issued before it; every launch
that may still be in flight owns a slot of its own (pinned input and
output, an event), and a slot is handed out again only once its event
completed and its bitmaps were copied out or dropped.

Each Space has its own mirror, so thread-mode builds never share one, and
each build-service process has its own.  On the CPU the mirror is a CPU
tensor and the scans run the plain version synchronously.

Because ``PlacementBackend.sessions`` stacks every sibling variant's
prescan into one ``scan_kernel`` call, the multi-variant node prescan is
a single device launch under this backend.

Exactness note: the grid is float32 while demands are float64.  Each
demand is pre-rounded *up* to the nearest float32 (``ceil32``): for
float32 a and float64 v, ``a >= v`` iff ``a >= ceil32(v)``, so the
all-float32 kernel is bit-identical to the float64 comparison.
"""

from __future__ import annotations

import os
import threading
import time
import weakref

import numpy as np

from . import kernels
from .base import ceil32, register_backend
from .batched import WINDOW0, BatchedBackend, BatchedSession

#: env var: the device batch floor, over the device's default
MIN_BATCH_ENV = "REPRO_JIT_MIN_BATCH"

#: batches smaller than this run through the dispatch layer instead
#: (outcome-identical).  ``None`` means "resolve per call":
#: ``min_device_g()`` consults REPRO_JIT_MIN_BATCH, else the device (4 on a
#: card, which amortizes a launch over a few rows; 16 on the CPU, where the
#: plain version's overhead dominates small batches).  Tests monkeypatch
#: this module attribute directly with an int.
MIN_DEVICE_G: int | None = None


def min_device_g() -> int:
    """The device batch floor: ``MIN_DEVICE_G`` when set, else
    REPRO_JIT_MIN_BATCH, else 4 on the cuda device and 16 on the cpu."""
    if MIN_DEVICE_G is not None:
        return MIN_DEVICE_G
    env = os.environ.get(MIN_BATCH_ENV)
    if env:
        return int(env)
    return 4 if kernels.current_device() == "cuda" else 16


#: counters: device launches, batches sent through the dispatch layer
#: instead, cells and bytes uploaded into mirrors (on the CPU, copied),
#: mirror buffers allocated and, of those, regrowths of a live mirror
PROFILE = {"device_calls": 0, "fallback_calls": 0, "sync_cells": 0,
           "bytes_h2d": 0, "allocs": 0, "reallocs": 0, "scan_seconds": 0.0}

#: guards PROFILE: thread-mode builds run sessions from worker threads
_PROF_LOCK = threading.Lock()


def _prof_add(key: str, n) -> None:
    with _PROF_LOCK:
        PROFILE[key] += n


def reset_profile() -> None:
    with _PROF_LOCK:
        for k in PROFILE:
            PROFILE[k] = 0.0 if k == "scan_seconds" else 0


def _align16(n: int) -> int:
    return (n + 15) & ~15


class DeviceGrid:
    """Persistent mirror of one Space's capacity grid on ``device``.

    Keeps a (m, Tb, d) float32 tensor addressed in *logical* ticks (stable
    across ``Space._grow_front``, which only shifts the physical origin).
    ``synced`` is the logical interval where mirror == host; ``dirty`` the
    sub-interval invalidated by commits or restores since the last upload.
    ``ensure(lo, hi)`` names exactly one bridging slab to upload so both
    intervals stay intervals — worst case the slab spans the occupied
    grid, typically it is the few frontier ticks the last commits touched.
    """

    def __init__(self, space, device: str):
        self.space = space
        self.device = device
        self.buf = None
        self.base = 0            # logical tick of buffer index 0
        self.Tb = 0
        self.s0 = self.s1 = 0    # synced logical interval [s0, s1)
        self.d0 = self.d1 = 0    # dirty sub-interval [d0, d1)
        self.stage = None
        if device == "cuda":
            from ...kernels.placement_scan import kernel as ps_kernel

            self.stage = ps_kernel.resident_stage(device)
        space.add_observer(self)

    # -- Space.observer protocol ---------------------------------------
    def on_commit(self, task, machine, start, k, v) -> None:
        self._mark(start, start + k)

    def on_restore(self, n_placed, lo, hi) -> None:
        if lo is not None:
            self._mark(lo, hi)
        # a shrink drops cells; if the grid later regrows there, host
        # content restarts at 1.0 while the mirror kept old values — clamp
        # the synced interval to the live extent so those cells re-upload
        sp = self.space
        self.s0 = max(self.s0, sp.grid_start)
        self.s1 = min(self.s1, sp.grid_end)
        if self.s0 >= self.s1:
            self.s0 = self.s1 = 0
        self.d0 = max(self.d0, self.s0)
        self.d1 = min(self.d1, self.s1)

    def _mark(self, lo: int, hi: int) -> None:
        if self.s0 >= self.s1:
            return                       # nothing synced: nothing to dirty
        lo, hi = max(lo, self.s0), min(hi, self.s1)
        if lo >= hi:
            return
        if self.d0 >= self.d1:
            self.d0, self.d1 = lo, hi
        else:
            self.d0, self.d1 = min(self.d0, lo), max(self.d1, hi)

    # ------------------------------------------------------------------
    @staticmethod
    def alloc_len(span: int) -> int:
        """Buffer length for a span of ticks: the power of two at or above
        twice the span, floored at twice the largest first-window read
        (WINDOW0 + LONG_K), so a buffer has room to grow at both ends and
        regrows geometrically."""
        need = 2 * max(span, WINDOW0 + kernels.LONG_K)
        return 1 << (need - 1).bit_length()

    def _alloc(self, lo: int, hi: int) -> None:
        """(Re)allocate the buffer so logical [lo, hi) and the live grid
        map inside it, centred; invalidates the synced state."""
        import torch

        sp = self.space
        lo_all, hi_all = min(lo, sp.grid_start), max(hi, sp.grid_end)
        span = hi_all - lo_all
        regrow = self.buf is not None
        self.Tb = self.alloc_len(span)
        self.base = lo_all - (self.Tb - span) // 2
        shape = (sp.m, self.Tb, sp.d)
        if self.stage is not None:
            with torch.cuda.stream(self.stage.stream):
                self.buf = torch.ones(shape, dtype=torch.float32,
                                      device=self.stage.device)
        else:
            self.buf = torch.ones(shape, dtype=torch.float32)
        self.s0 = self.s1 = 0
        self.d0 = self.d1 = 0
        _prof_add("allocs", 1)
        if regrow:
            _prof_add("reallocs", 1)

    def ensure(self, lo: int, hi: int, slack: int) -> tuple[int, int] | None:
        """Mark logical [lo, hi) to be made equal to the host, keeping
        ``slack`` ticks past ``lo`` inside the buffer; returns the slab
        ``(u0, Sb)`` (logical first tick, length) to upload, or None when
        the range is clean.  The caller uploads it (`_write_slab`) before
        its next scan."""
        if (self.buf is None or lo < self.base
                or lo + slack > self.base + self.Tb):
            self._alloc(lo, max(hi, lo + slack))
        # pieces of [lo, hi) that are not clean in the mirror right now
        pieces = []
        if self.s0 >= self.s1:
            pieces.append((lo, hi))
        else:
            if self.d0 < self.d1:                     # stale synced cells
                p0, p1 = max(self.d0, lo), min(self.d1, hi)
                if p0 < p1:
                    pieces.append((p0, p1))
            if lo < self.s0:                          # never-synced cells
                pieces.append((lo, min(hi, self.s0)))
            if hi > self.s1:
                pieces.append((max(lo, self.s1), hi))
        if not pieces:
            return None
        u0 = min(p[0] for p in pieces)
        u1 = max(p[1] for p in pieces)
        if self.s0 < self.s1:
            # bridge to the synced interval so it stays one interval
            if u0 > self.s1:
                u0 = self.s1
            elif u1 < self.s0:
                u1 = self.s0
        if self.s0 >= self.s1:
            self.s0, self.s1 = u0, u1
        else:
            self.s0, self.s1 = min(self.s0, u0), max(self.s1, u1)
        # drop the covered part of the dirty interval; an upload strictly
        # inside it keeps the hull (conservative: re-uploads a few clean
        # cells later rather than ever trusting a stale one)
        if self.d0 < self.d1:
            if u0 <= self.d0 and self.d1 <= u1:
                self.d0 = self.d1 = 0
            elif self.d0 < u0 and self.d1 > u1:
                pass
            elif self.d0 < u0:
                self.d1 = min(self.d1, u0)
            else:
                self.d0 = max(self.d0, u1)
        return u0, u1 - u0

    def _slab(self, u0: int, Sb: int, out: np.ndarray) -> None:
        """The host's content of logical ticks [u0, u0 + Sb) into ``out``
        (m, Sb, d) float32; cells beyond the live grid read 1.0, exactly the
        content the host materializes if the grid later grows there."""
        sp = self.space
        h0, h1 = max(u0, sp.grid_start), min(u0 + Sb, sp.grid_end)
        if h0 > u0 or h1 < u0 + Sb:
            out[...] = 1.0
        if h0 < h1:
            out[:, h0 - u0:h1 - u0, :] = sp.avail[:, h0 + sp.off:h1 + sp.off, :]
        _prof_add("sync_cells", out.size)
        _prof_add("bytes_h2d", out.nbytes)

    # ------------------------------------------------------------------
    def launch(self, Vs, ks, plo, phi, reverse) -> "_DeviceRows":
        """Scan of the physical window [plo, phi) for demands Vs (g, d) and
        durations ks (g,): syncs the mirror, launches, returns a lazy row
        view.  On the card nothing waits until a row is read; the scan sees
        the grid as it was at launch (see the module docstring)."""
        import torch

        t0 = time.perf_counter()
        sp = self.space
        m, T, d = sp.avail.shape
        g = len(ks)
        W = phi - plo
        kmax = int(ks.max())
        hi_read = min(T, phi + kmax - 1)
        L = hi_read - plo
        lo_l, hi_l = plo - sp.off, hi_read - sp.off   # logical window
        slab = self.ensure(lo_l, hi_l, slack=W + kmax)
        first = lo_l - self.base
        Vs32 = ceil32(np.asarray(Vs)).astype(np.float32)
        if self.stage is not None:
            from ...kernels.placement_scan import kernel as ps_kernel

            off_vs = _align16(m * slab[1] * d * 4) if slab else 0
            n_in = _align16(off_vs + g * d * 4) + g * 4
            slot = self.stage.acquire(n_in, g * W * m)
            if slab is not None:
                u0, Sb = slab
                self._slab(u0, Sb, slot.h_in_np[:m * Sb * d * 4]
                           .view(np.float32).reshape(m, Sb, d))
                ps_kernel.copy_slab(self.buf, u0 - self.base, Sb, slot,
                                    self.stage)
            ps_kernel.scan_resident(self.buf, first, L, Vs32, ks, W, reverse,
                                    off_vs, slot, self.stage)
            _prof_add("bytes_h2d", g * d * 4 + g * 4)
            rows = _DeviceRows(g, W, m, slot=slot, stage=self.stage)
        else:
            from ...kernels.placement_scan import ops as ps_ops

            if slab is not None:
                u0, Sb = slab
                host = np.empty((m, Sb, d), dtype=np.float32)
                self._slab(u0, Sb, host)
                self.buf[:, u0 - self.base:u0 - self.base + Sb, :] = \
                    torch.from_numpy(host)
            # the plain version reads W + kmax ticks; those past the L live
            # ones are masked by t_live
            win = self.buf[:, first:first + W + kmax, :]
            out = ps_ops.scan_bitmaps(
                win, torch.from_numpy(Vs32),
                torch.from_numpy(np.asarray(ks, dtype=np.int32)), L, W=W)
            good = out.numpy() != 0
            if reverse:
                good = good[:, ::-1, :]
            rows = _DeviceRows(g, W, m, host=np.ascontiguousarray(
                good).reshape(g, W * m))
        _prof_add("device_calls", 1)
        _prof_add("scan_seconds", time.perf_counter() - t0)
        return rows


class _DeviceRows:
    """Lazy view over one launched scan's (g, W, m) bitmaps.

    ``row(i)`` waits for the launch once (first access), copies every row
    out of the launch's slot and gives the slot back; rows come in walk
    order, (W * m,) each.  A view dropped unread gives its slot back too
    (its event is waited on before the slot is used again)."""

    __slots__ = ("host", "g", "W", "m", "_slot", "_release", "__weakref__")

    def __init__(self, g: int, W: int, m: int, slot=None, stage=None,
                 host: np.ndarray | None = None):
        self.g, self.W, self.m = g, W, m
        self.host = host
        self._slot = slot
        self._release = (weakref.finalize(self, stage.release, slot)
                         if slot is not None else None)

    def row(self, i: int) -> np.ndarray:
        if self.host is None:
            slot = self._slot
            slot.wait()
            n = self.g * self.W * self.m
            self.host = slot.h_out_np[:n].reshape(self.g,
                                                  self.W * self.m).copy()
            self._slot = None
            self._release()
        return self.host[i]

    def loader(self, i: int):
        return lambda: self.row(i)


class JitBackend(BatchedBackend):
    name = "jit"

    @classmethod
    def available(cls) -> bool:
        return True

    @classmethod
    def prewarm(cls, m: int, d: int, T: int | None = None) -> None:
        """Allocate ahead of use: on the card, this thread's resident
        stage (its stream) and one slot sized for a first window of a full
        batch.  There is nothing to compile."""
        if kernels.current_device() != "cuda":
            return
        from ...kernels.placement_scan import kernel as ps_kernel
        from .batched import MAX_BATCH

        stage = ps_kernel.resident_stage("cuda")
        if stage.slots:
            return
        L = WINDOW0 + kernels.LONG_K
        g = MAX_BATCH + 1
        n_in = _align16(m * L * d * 4) + _align16(g * d * 4) + g * 4
        stage.release(stage.acquire(n_in, g * WINDOW0 * m))

    @staticmethod
    def mirror(space) -> DeviceGrid:
        """The Space's mirror on the current device, made on first use."""
        dev = kernels.current_device()
        dg = getattr(space, "_device_grid", None)
        if dg is None or dg.device != dev:
            if dg is not None:
                space.remove_observer(dg)
            dg = DeviceGrid(space, dev)
            space._device_grid = dg
        return dg

    def scan_kernel(self, space, Vs, ks, plo, phi, reverse):
        g = len(ks)
        if g < max(min_device_g(), 2):
            # through the dispatch layer: launch overhead beats the work
            # for tiny batches, and the hybrid split below needs at least
            # one peer row
            _prof_add("fallback_calls", 1)
            return kernels.scan(space.avail, Vs, ks, plo, phi, reverse)
        # hybrid split: row 0 — the task the session walks immediately —
        # runs through the dispatch layer's g=1 call so the caller never
        # waits on the mirror's launch; the peer rows launch asynchronously
        # and materialize when (if ever) their tasks pop, by which time the
        # device has finished behind the host-side walk
        row0 = kernels.scan(space.avail, Vs[:1], ks[:1], plo, phi, reverse)
        rows = self.mirror(space).launch(Vs[1:], ks[1:], plo, phi, reverse)
        out = [None] * g
        out[0] = lambda: row0[0]
        for i in range(1, g):
            out[i] = rows.loader(i - 1)
        return out

    def session(self, space, direction: str) -> BatchedSession:
        self.prewarm(space.m, space.d, space.T)
        return BatchedSession(space, direction, self)


register_backend("jit", JitBackend)
