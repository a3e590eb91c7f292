"""Device-resident heartbeat wave: fused eligibility→score→pick.

One wave of the online matcher (`ShardedMatcher.match_wave`) is, on the
host path, a Python loop over machines in descending-capacity order, each
iteration running `Matcher.match_batch`.  This module turns the whole wave
into one registry op (``match_wave`` in `core/engine/kernels.py`) with
three implementations:

  numpy  — the host loop (the decision oracle).
  cuda   — ``kernels/placement_scan`` ``match_wave_walk`` on the card: the
           whole wave in one launch over device-resident matcher state.
  torch  — the same walk's plain PyTorch version on CPU tensors.

Exactness.  The matcher's decisions must stay bit-identical to the numpy
oracle, so every float op runs in float64 and every product is rounded
before the add that consumes it (the CUDA source is built with
``-fmad=false`` and spells each multiply and add as its own rounded
intrinsic; PyTorch's elementwise ops round per op).  The packing score is
`core/online.py::seq_dot`, an explicit left-to-right accumulation that
both sides share, and every argmax takes the first maximal index.

State residency.  A `DeviceWaveState` (one per `ShardedMatcher` and impl)
keeps the ``avail`` matrix, candidate columns, EMA pair and dense deficit
ledger on the device across waves.  Host-side shadows detect what actually
changed: ``avail`` rows touched by task finishes/failures re-upload (dirty
rows only), candidate columns re-upload only when `TaskPool.refresh`
rebuilt them (array identity), the EMA/deficit ledgers re-upload only if
the host replay diverged from the device's own update (never, absent
external edits), and the dim masks and scalar constants only when the
config changes.  Whatever a wave does upload (the visit order at least)
goes in one host-to-device copy: the arrays are staged into one packed
buffer and the device copies are views of it; the picks come back in one
device-to-host copy.

No host fallback.  Every wave the cuda or torch impl is handed runs
through the kernel or its plain version.  A candidate whose group the
deficit ledger does not hold maps to a spare ledger slot (share 0, deficit
-inf) that is never the most deprived group and that a pick leaves at -inf;
picking such a candidate raises the ledger's KeyError in the host replay,
as the numpy loop does.  A fairness function other than DRF or slot
fairness has no device form: the wave raises NotImplementedError, and a
caller who wants the host loop pins ``REPRO_KERNELS=match_wave=numpy``.

Fault seam: the op dispatches through ``kernels._run_op``, so an injected
``kernel_impl`` fault sticky-demotes the wave down the chain mid-run with
zero decision drift — the device impls mutate no matcher state before
their launch returns.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable

import numpy as np

from . import packing

if TYPE_CHECKING:  # runtime import would cycle: online -> engine -> here
    from ..online import CandidateBatch, Matcher


@dataclasses.dataclass
class WaveContext:
    """One heartbeat wave's inputs, handed to the ``match_wave`` op.

    ``start_cb(row, machine)`` applies a pick's side effects (including
    the host ``avail[machine] -= demand`` update); rows index ``batch``.
    """

    sm: object                 # the owning core.shard.ShardedMatcher
    avail: np.ndarray          # (m, d) float64, mutated by start_cb
    alive: np.ndarray          # (m,) bool
    batch: CandidateBatch
    start_cb: Callable[[int, int], None]


# ----------------------------------------------------------------------
# numpy implementation — the reference wave loop
# ----------------------------------------------------------------------

def match_wave_numpy(ctx: WaveContext) -> int:
    """The host wave loop (decision oracle for the fused kernels)."""
    sm, avail, alive, batch = ctx.sm, ctx.avail, ctx.alive, ctx.batch
    start_cb = ctx.start_cb
    eligible, machine_any = sm.eligibility(avail, batch.dem)
    active = np.ones(len(batch), dtype=bool)
    n_active = len(batch)
    order = np.argsort(-avail.sum(axis=1))
    # visit only machines that can possibly pick: dead, drained, or
    # candidate-less machines are guaranteed matcher no-ops
    ok = (alive[order] & (avail[order] > 1e-9).any(axis=1)
          & machine_any[order])
    matcher = sm.matcher
    cfg = sm.cfg
    n_picks = 0
    for m in order[ok].tolist():
        if n_active == 0:
            break
        if not (eligible[:, m] & active).any():
            continue
        picks = matcher.match_batch(m, avail[m], batch, active=active)
        if picks:
            ledger = sm.shard_matchers[sm.plan.shard_of(m)].deficits
            for gi, _over in picks:
                start_cb(gi, m)
                active[gi] = False
                ledger.allocated(int(batch.grp[gi]),
                                 cfg.fairness(batch.dem[gi]))
            n_active -= len(picks)
            n_picks += len(picks)
    return n_picks


#: consts vector layout (f64 scalars uploaded per call): eps, overbook
#: slack, remote penalty, eta_m, must-serve threshold (kappa * capacity),
#: EMA step a, 1 - a, srpt floor
_C_EPS, _C_SLACK, _C_RP, _C_ETA_M, _C_THRESH, _C_A, _C_1MA, _C_FLOOR = \
    range(8)
_EMA_A = 0.05
_EMA_1MA = 1.0 - 0.05          # bound host-side once; uploaded, never re-derived
_SRPT_FLOOR = 1e-12


def load_matcher_state(matcher: "Matcher", ema_score: float, ema_srpt: float,
                       deficit: dict, share: dict) -> None:
    """Carry a matcher's state over: its EMA pair and deficit/share ledgers.

    A scheduler has no weights; this is the state a wave reads.  Feeding
    the same values to the reference package's `Matcher` and to this one
    puts both waves at the same starting point.
    """
    matcher._ema_score = float(ema_score)
    matcher._ema_srpt = float(ema_srpt)
    matcher.deficits.deficit = {int(g): float(v) for g, v in deficit.items()}
    matcher.deficits.share = {int(g): float(v) for g, v in share.items()}


# ----------------------------------------------------------------------
# device-resident wave state (one per ShardedMatcher and impl)
# ----------------------------------------------------------------------

class DeviceWaveState:
    """Host-shadowed device mirrors for the fused wave.

    The shadows are plain numpy copies of what the device currently
    holds; before each wave the host state is diffed against them and
    only the difference is uploaded.  After a wave, the host replay
    applies the same arithmetic the kernel did, so the refreshed shadows
    equal the device buffers bit-for-bit and steady-state waves upload
    nothing but the machine order and whatever the simulator touched.
    """

    def __init__(self, device: str):
        self.device = device
        self.avail_dev = None
        self.avail_shadow = None
        # candidate-column cache: array identities of the last upload, and
        # the arrays themselves, held so that no new array can take a
        # freed one's id (CPython reuses the address of a freed object)
        self.n_cap = 0
        self.col_ids = None
        self.col_refs = None
        self.dem_dev = self.pri_dev = self.srpt_dev = None
        self.gidx_dev = self.loc_dev = self.taken0_dev = None
        self.gidx_np = None
        self.ones_dev = None
        # ledger mirrors
        self.keys = None               # deficit key order at last upload
        self.keys_sorted = None        # the keys ascending ...
        self.keys_rank = None          # ... and each one's dense index
        self.g_cap = 0
        self.ema_dev = None
        self.ema_shadow = None
        self.deficit_dev = None
        self.deficit_shadow = None
        self.share_dev = None
        # dim masks and scalar constants, re-staged when they change
        self.static_key = None
        self.fd_dev = self.rd_dev = self.fg_dev = self.consts_dev = None
        self.order_dev = None
        # avail rows to scatter into the mirror after the next flush
        self.dirty_rows_dev = self.dirty_vals_dev = None
        self._staged: list[tuple[str, np.ndarray]] = []

    def stage(self, attr: str, a: np.ndarray) -> None:
        """Queue a host array for the next `flush`, whose device copy
        lands in attribute ``attr``."""
        self._staged.append((attr, np.ascontiguousarray(a)))

    def flush(self) -> None:
        """Upload every staged array in one host-to-device copy: 8-byte
        aligned slices of one buffer, each attribute set to its typed view."""
        import torch

        from .kernels import _up

        if not self._staged:
            return
        offs, total = [], 0
        for _attr, a in self._staged:
            offs.append(total)
            total += (a.nbytes + 7) & ~7
        buf = np.zeros(total, dtype=np.uint8)
        for (_attr, a), o in zip(self._staged, offs):
            buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        dev = _up(buf, self.device)
        for (attr, a), o in zip(self._staged, offs):
            dt = torch.from_numpy(a[:0].reshape(-1)).dtype
            setattr(self, attr, dev[o:o + a.nbytes].view(dt).view(a.shape))
        self._staged = []


def _bstat(impl: str, key: str, n) -> None:
    from . import kernels as K

    K.transfer_add(f"match_wave.{impl}.{key}", int(n))


def _sync_avail(st: DeviceWaveState, avail: np.ndarray, impl: str) -> int:
    """Stage only rows that changed since the last wave's replay (scattered
    into the mirror by `wave_launch_args` after the flush).

    Returns the number of extra device launches used (0 or 1)."""
    from . import kernels as K

    m, d = avail.shape
    st.dirty_rows_dev = st.dirty_vals_dev = None
    if st.avail_shadow is None or st.avail_shadow.shape != avail.shape:
        st.stage("avail_dev", avail.astype(np.float64))
        st.avail_shadow = avail.copy()
        _bstat(impl, "bytes_h2d", avail.nbytes)
        return 0
    dirty = np.flatnonzero((st.avail_shadow != avail).any(axis=1))
    if len(dirty) == 0:
        return 0
    if len(dirty) * 2 >= m:
        st.stage("avail_dev", avail.astype(np.float64))
        st.avail_shadow = avail.copy()
        _bstat(impl, "bytes_h2d", avail.nbytes)
        return 0
    r_cap = K.bucket(len(dirty), floor=8)
    rows = np.zeros(r_cap, dtype=np.int64)
    rows[:len(dirty)] = dirty
    rows[len(dirty):] = dirty[0]       # duplicate writes carry equal values
    st.stage("dirty_rows_dev", rows)
    st.stage("dirty_vals_dev", avail[rows].astype(np.float64))
    st.avail_shadow[dirty] = avail[dirty]
    _bstat(impl, "bytes_h2d", rows.nbytes + rows.nbytes * d)
    return 1


def _sync_batch(st: DeviceWaveState, batch: CandidateBatch,
                impl: str) -> None:
    """Upload candidate columns that `TaskPool.refresh` actually rebuilt.

    Column array identity is the dirtiness signal: the pool reuses cached
    rows for clean jobs and swaps only the srpt column on srpt-only
    refreshes, so steady-state waves re-upload nothing.  Groups the ledger
    does not hold map to its spare slot (see `_sync_ledgers`).
    """
    from . import kernels as K

    n = len(batch)
    n_cap = K.bucket(n, floor=64)
    ids = (id(batch.dem), id(batch.pri), id(batch.srpt), id(batch.grp),
           id(batch.loc), n)
    if st.n_cap == n_cap and st.col_ids == ids and st.gidx_np is not None:
        return
    rebuild = st.n_cap != n_cap or st.col_ids is None \
        or st.col_ids[0] != ids[0] or st.col_ids[5] != n
    if rebuild or st.col_ids[3] != ids[3]:
        grp = np.asarray(batch.grp, dtype=np.int64)
        gidx = np.full(n, len(st.keys), dtype=np.int64)
        if len(st.keys):
            pos = np.minimum(np.searchsorted(st.keys_sorted, grp),
                             len(st.keys) - 1)
            known = st.keys_sorted[pos] == grp
            gidx[known] = st.keys_rank[pos[known]]
        gp = np.zeros(n_cap, dtype=np.int32)
        gp[:n] = gidx
        st.gidx_np = gidx
        st.stage("gidx_dev", gp)
        _bstat(impl, "bytes_h2d", gp.nbytes)
    if rebuild:
        dem = np.full((n_cap, batch.dem.shape[1]), 2.0, dtype=np.float64)
        dem[:n] = batch.dem
        taken0 = np.ones(n_cap, dtype=bool)
        taken0[:n] = False
        st.stage("dem_dev", dem)
        st.stage("taken0_dev", taken0)
        ones = np.zeros(n_cap, dtype=np.float64)
        ones[:n] = 1.0
        st.stage("ones_dev", ones)
        _bstat(impl, "bytes_h2d", dem.nbytes + taken0.nbytes + ones.nbytes)
    if rebuild or st.col_ids[1] != ids[1]:
        pri = np.zeros(n_cap, dtype=np.float64)
        pri[:n] = batch.pri
        st.stage("pri_dev", pri)
        _bstat(impl, "bytes_h2d", pri.nbytes)
    if rebuild or st.col_ids[2] != ids[2]:
        srpt = np.zeros(n_cap, dtype=np.float64)
        srpt[:n] = batch.srpt
        st.stage("srpt_dev", srpt)
        _bstat(impl, "bytes_h2d", srpt.nbytes)
    if rebuild or st.col_ids[4] != ids[4]:
        loc = np.full(n_cap, -1, dtype=np.int32)
        loc[:n] = batch.loc
        st.stage("loc_dev", loc)
        _bstat(impl, "bytes_h2d", loc.nbytes)
    st.n_cap = n_cap
    st.col_ids = ids
    st.col_refs = (batch.dem, batch.pri, batch.srpt, batch.grp, batch.loc)


def _sync_ledgers(st: DeviceWaveState, matcher, impl: str) -> None:
    """EMA pair + dense deficit/share mirrors (key order = dict order).

    The dense ledger always has a slot past the keys (share 0, deficit
    -inf) for candidates of a group the ledger does not hold: it is never
    the first argmax while a key exists, and a pick's update leaves it at
    -inf.  Steady state, the post-replay shadows match the host exactly
    and nothing uploads.
    """
    from . import kernels as K

    keys = list(matcher.deficits.deficit.keys())
    g_cap = K.pad8(len(keys) + 1)
    dfc = matcher.deficits
    if keys != st.keys or g_cap != st.g_cap:
        st.keys = keys
        st.g_cap = g_cap
        share = np.zeros(g_cap, dtype=np.float64)
        share[:len(keys)] = [dfc.share[g] for g in keys]
        st.stage("share_dev", share)
        st.deficit_shadow = None
        _bstat(impl, "bytes_h2d", share.nbytes)
        # group id -> dense index, by binary search over the sorted keys
        kk = np.asarray(keys, dtype=np.int64)
        st.keys_rank = np.argsort(kk, kind="stable")
        st.keys_sorted = kk[st.keys_rank]
        st.col_ids = None              # gidx depends on the key order
    deficit = np.full(g_cap, -np.inf, dtype=np.float64)
    deficit[:len(keys)] = [dfc.deficit[g] for g in keys]
    if st.deficit_shadow is None \
            or not np.array_equal(st.deficit_shadow, deficit):
        st.stage("deficit_dev", deficit)
        st.deficit_shadow = deficit
        _bstat(impl, "bytes_h2d", deficit.nbytes)
    ema = np.array([matcher._ema_score, matcher._ema_srpt],
                   dtype=np.float64)
    if st.ema_shadow is None or not np.array_equal(st.ema_shadow, ema):
        st.stage("ema_dev", ema)
        st.ema_shadow = ema
        _bstat(impl, "bytes_h2d", ema.nbytes)


def wave_consts(matcher) -> np.ndarray:
    """The (8,) f64 consts vector of one wave (layout: _C_*)."""
    cfg = matcher.cfg
    consts = np.zeros(8, dtype=np.float64)
    consts[_C_EPS] = packing.EPS
    consts[_C_SLACK] = cfg.max_overbook - 1.0
    consts[_C_RP] = cfg.remote_penalty
    consts[_C_ETA_M] = cfg.eta_m
    consts[_C_THRESH] = matcher.deficits.kappa * matcher.deficits.capacity
    consts[_C_A] = _EMA_A
    consts[_C_1MA] = _EMA_1MA
    consts[_C_FLOOR] = _SRPT_FLOOR
    return consts


def visit_order(avail: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """Host-computed visit order, -1-padded to (m,) int32.

    ``np.argsort`` is the numpy wave's own sort (its tie order decides
    which machine is visited first); the alive/drained prefilter mirrors
    the numpy wave, and machines it would skip via eligibility are
    decision-free in-kernel visits.
    """
    m = avail.shape[0]
    order = np.argsort(-avail.sum(axis=1))
    keep = (alive & (avail > 1e-9).any(axis=1))[order]
    order_p = np.full(m, -1, dtype=np.int32)
    kept = order[keep]
    order_p[:len(kept)] = kept
    return order_p


def wave_launch_args(st: DeviceWaveState, sm, batch: CandidateBatch,
                     avail: np.ndarray, alive: np.ndarray,
                     impl: str) -> tuple[tuple, dict, int]:
    """Sync the mirrors and assemble one wave launch.

    Returns ``(args, kw, syncs)``: ``match_wave_walk``'s operands and the
    number of extra device launches the avail sync used (0 or 1).  A
    fairness function other than DRF or slot fairness has no device form
    and raises NotImplementedError before any mirror changes.
    """
    from ..online import drf_fairness, slot_fairness

    matcher = sm.matcher
    cfg = sm.cfg
    if cfg.fairness is drf_fairness:
        drf = True
    elif cfg.fairness is slot_fairness:
        drf = False
    else:
        raise NotImplementedError(
            f"the {impl} wave runs DRF or slot fairness only, not "
            f"{cfg.fairness!r}; set REPRO_KERNELS=match_wave=numpy to run "
            "this fairness function in the host wave loop")
    d = avail.shape[1]
    _sync_ledgers(st, matcher, impl)
    _sync_batch(st, batch, impl)
    syncs = _sync_avail(st, avail, impl)
    masks = []
    for dims in matcher.fit_dim_split():
        mk = np.zeros(d, dtype=bool)
        mk[np.asarray(dims, dtype=np.int64)] = True
        masks.append(mk)
    consts = wave_consts(matcher)
    key = (*(mk.tobytes() for mk in masks), consts.tobytes())
    if key != st.static_key:
        for attr, a in zip(("fd_dev", "rd_dev", "fg_dev", "consts_dev"),
                           (*masks, consts)):
            st.stage(attr, a)
        st.static_key = key
        _bstat(impl, "bytes_h2d", consts.nbytes + 3 * d)
    order_p = visit_order(avail, alive)
    st.stage("order_dev", order_p)
    _bstat(impl, "bytes_h2d", order_p.nbytes)
    st.flush()
    if st.dirty_rows_dev is not None:
        # in place: the resident mirror is this state's own buffer
        st.avail_dev.index_copy_(0, st.dirty_rows_dev, st.dirty_vals_dev)
    args = (st.avail_dev, st.order_dev, st.dem_dev,
            st.pri_dev if cfg.use_priority else st.ones_dev, st.srpt_dev,
            st.gidx_dev, st.loc_dev, st.taken0_dev, st.ema_dev,
            st.deficit_dev, st.share_dev, st.fd_dev, st.rd_dev, st.fg_dev,
            st.consts_dev)
    kw = dict(bundle_limit=cfg.bundle_limit, use_packing=cfg.use_packing,
              use_srpt=cfg.use_srpt, use_overbooking=cfg.use_overbooking,
              drf=drf)
    return args, kw, syncs


def device_wave(ctx: WaveContext, impl: str, device: str) -> int:
    """cuda/torch driver: sync mirrors, launch, replay the picks.

    The walk tests eligibility inside its own pass, so it never asks
    ``ShardedMatcher.eligibility`` for a machine filter and never passes
    the ``shard_launch`` fault seam (nor its retry and quarantine), exactly
    like the reference's device wave.  Only the numpy loop does; a run
    that exercises the seam pins ``REPRO_KERNELS=match_wave=numpy``, the
    wave the reference runs below its 1536-machine promotion threshold.
    """
    import torch

    from ...kernels.placement_scan import ops as ps_ops

    sm, avail, batch = ctx.sm, ctx.avail, ctx.batch
    matcher = sm.matcher
    states = getattr(sm, "_wave_states", None)
    if states is None:
        states = sm._wave_states = {}
    st = states.get(impl)
    if st is None:
        st = states[impl] = DeviceWaveState(device)
    args, kw, syncs = wave_launch_args(st, sm, batch, avail, ctx.alive, impl)
    out = ps_ops.match_wave_walk(*args, **kw)
    st.avail_dev, st.ema_dev, st.deficit_dev = out[0], out[1], out[2]
    # the picks in one device-to-host copy: obs, rows, machines, count
    n = out[3].shape[0]
    blob = torch.cat([t.reshape(-1).view(torch.uint8)
                      for t in (out[6], out[3], out[4], out[7].reshape(1))])
    blob = blob.cpu().numpy()
    count = int(blob[16 * n:].view(np.int32)[0])
    obs = blob[:8 * n].view(np.float64)[:count]
    rows = blob[8 * n:12 * n].view(np.int32)[:count]
    mach = blob[12 * n:16 * n].view(np.int32)[:count]
    _bstat(impl, "bytes_d2h", blob.nbytes)
    _bstat(impl, "launches", 1 + syncs)
    _bstat(impl, "waves", 1)
    # -- host replay: apply every pick's side effects in pick order ------
    plan = sm.plan
    fairness = sm.cfg.fairness
    for j in range(count):
        gi = int(rows[j])
        mm = int(mach[j])
        ctx.start_cb(gi, mm)
        matcher._observe(float(obs[j]), float(batch.srpt[gi]))
        w = fairness(batch.dem[gi])
        matcher.deficits.allocated(int(batch.grp[gi]), w)
        sm.shard_matchers[plan.shard_of(mm)].deficits.allocated(
            int(batch.grp[gi]), w)
    # refresh shadows from the replayed host state: the kernel applied
    # identical float64 ops, so these equal the device buffers bit-for-bit
    # and the next wave's diffs only see *external* mutations
    st.avail_shadow = avail.copy()
    st.ema_shadow = np.array([matcher._ema_score, matcher._ema_srpt],
                             dtype=np.float64)
    dfc = matcher.deficits
    sh = np.full(st.g_cap, -np.inf, dtype=np.float64)
    sh[:len(st.keys)] = [dfc.deficit[g] for g in st.keys]
    st.deficit_shadow = sh
    return count
