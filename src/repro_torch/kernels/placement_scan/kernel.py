"""Build, bind and launch the placement-scan CUDA kernels.

``csrc/placement_scan.cu`` is compiled with ``nvcc -fmad=false`` at first
use into a shared library with a plain C interface and loaded through
``ctypes`` (``kernels/build.py``).

Each wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, raises if ``cudaGetLastError`` reports a refused
launch, and adds one to its entry in ``LAUNCHES``.  Nothing here is
imported or compiled until a wrapper runs on a CUDA tensor.

`scan_call` is the builder's whole scan in one C call (``ps_scan_call``):
the window, demands and durations packed into one pinned host buffer and
copied to the card at once, the launch writing the bitmaps into pinned
host memory, one stream synchronize; the buffers and the call's stream
(`CallStage`) are made once and reused.  `eligible_call` stages the
matcher's heartbeat eligibility the same way (``ps_eligible_call``), with
the directed rounding on the card.  Both run on many threads at once (the
shard threads; the build service's worker threads), so each thread has a
stage of its own (`thread_stage`): calls overlap instead of queueing
behind one lock, and no two threads share a pinned buffer.

`scan_resident` is the jit placement backend's scan (``ps_scan_resident``):
the window is read in place out of a grid mirror that stays on the card,
and the call returns without waiting; the bitmaps land in a
`ResidentSlot` of the thread's `ResidentStage`, whose event says when
they may be read.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from ..build import NvccLibrary, check_launch as _check, need as _need, \
    ptr as _p, stream as _stream

_SRC = Path(__file__).resolve().parent / "csrc" / "placement_scan.cu"
#: bit-exact float math: no fused multiply-adds anywhere in the source
NVCC_FLAGS = ("-fmad=false",)

#: launches per kernel since the last `reset_launches` (the wrappers below
#: are the only writers: one per kernel launch, nowhere else)
LAUNCHES = {"scan_bitmaps": 0, "heartbeat_eligible": 0, "match_wave_walk": 0}
#: the staged calls count from many threads at once
_COUNT_LOCK = threading.Lock()


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1

#: wave kernel flag bits (csrc/placement_scan.cu F_*)
F_PACKING, F_SRPT, F_OVERBOOK, F_DRF = 1, 2, 4, 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _bind(handle: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    handle.ps_scan_bitmaps.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp, vp]
    handle.ps_scan_call.argtypes = ([vp, ll, ll, i, i, i, ctypes.c_char_p,
                                     ctypes.c_char_p, i, i, i, vp, vp, ll,
                                     ll, vp, vp])
    handle.ps_scan_resident.argtypes = ([vp, ll, ll, i, i, i,
                                         ctypes.c_char_p, ctypes.c_char_p,
                                         i, i, i, vp, vp, ll, ll, vp, vp,
                                         vp])
    handle.ps_copy_slab.argtypes = [vp, ll, ll, i, i, i, vp, vp]
    handle.ps_event_create.argtypes = [ctypes.POINTER(vp)]
    handle.ps_event_sync.argtypes = [vp]
    handle.ps_host_device_ptr.argtypes = [vp, ctypes.POINTER(vp)]
    handle.ps_heartbeat_eligible.argtypes = [vp] * 6 + [i, i, i, vp, vp]
    f64, u32 = ctypes.c_double, ctypes.c_uint
    elig = [vp, vp, i, i, i, f64, f64, u32, u32, u32]
    handle.ps_eligible_launch.argtypes = elig + [vp, vp, vp]
    handle.ps_eligible_call.argtypes = elig + [vp, vp, ll, vp, ll, vp]
    handle.ps_match_wave.argtypes = (
        [vp, vp, i, vp, vp, vp, vp, vp, vp, i, vp, vp, vp, i, vp, vp,
         i, i, i, vp, vp, vp, vp, vp, vp])
    for fn in (handle.ps_scan_bitmaps, handle.ps_scan_call,
               handle.ps_scan_resident, handle.ps_copy_slab,
               handle.ps_event_create, handle.ps_event_sync,
               handle.ps_host_device_ptr, handle.ps_heartbeat_eligible,
               handle.ps_eligible_launch, handle.ps_eligible_call,
               handle.ps_match_wave):
        fn.restype = ctypes.c_int


LIBRARY = NvccLibrary("placement_scan", _SRC, NVCC_FLAGS, _bind)
build = LIBRARY.build
lib = LIBRARY.lib


def scan_bitmaps(win: torch.Tensor, Vs: torch.Tensor, ks: torch.Tensor,
                 t_live: int, W: int) -> torch.Tensor:
    """win (m, L, d) f32; Vs (g, d) f32; ks (g,) i32 -> (g, W, m) int8."""
    m, L, d = win.shape
    g = Vs.shape[0]
    dev = win.device
    _need(win, "win", torch.float32, (m, L, d), dev)
    _need(Vs, "Vs", torch.float32, (g, d), dev)
    _need(ks, "ks", torch.int32, (g,), dev)
    if W > L:
        raise ValueError(f"scan_bitmaps needs L >= W + max(ks): L={L} W={W}")
    out = torch.empty((g, W, m), dtype=torch.int8, device=dev)
    err = lib().ps_scan_bitmaps(_p(win), _p(Vs), _p(ks), int(t_live), m, L, d,
                                g, int(W), _p(out), _stream(win))
    _check(err, "scan_bitmaps")
    _count("scan_bitmaps")
    return out


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _addr(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


class PinnedBuffers:
    """A call's host-side buffers on one device: a pinned host buffer for the
    packed inputs (``h_in``, as bytes in ``h_in_np``) and its device twin
    (``d_in``), and a pinned host buffer the kernel writes its results into
    (``h_out``, as bools in ``h_out_np``; ``h_out_dev`` is the card's
    address of it).  They grow to the next power of two, at least
    ``1 << MIN_BITS`` bytes, when a call needs more and are reused
    otherwise, so a caller copies what it reads out before the next call."""

    MIN_BITS = 16

    def __init__(self, device: torch.device):
        self.device = device
        self.cap_in = self.cap_out = 0

    def reserve(self, n_in: int, n_out: int) -> None:
        if n_in > self.cap_in:
            self.cap_in = 1 << max(self.MIN_BITS, (n_in - 1).bit_length())
            self.h_in = torch.empty(self.cap_in, dtype=torch.uint8,
                                    pin_memory=True)
            self.h_in_np = self.h_in.numpy()
            self.d_in = torch.empty(self.cap_in, dtype=torch.uint8,
                                    device=self.device)
            self.h_in_ptr = self.h_in.data_ptr()
            self.d_in_ptr = self.d_in.data_ptr()
        if n_out > self.cap_out:
            self.cap_out = 1 << max(self.MIN_BITS, (n_out - 1).bit_length())
            self.h_out = torch.empty(self.cap_out, dtype=torch.uint8,
                                     pin_memory=True)
            self.h_out_np = self.h_out.numpy().view(bool)
            dev = ctypes.c_void_p()
            _check(lib().ps_host_device_ptr(self.h_out.data_ptr(),
                                            ctypes.byref(dev)),
                   "staged call (pinned output)")
            self.h_out_dev = dev.value


class CallStage(PinnedBuffers):
    """A staged call's resources: its `PinnedBuffers` and a stream of the
    call's own, which it synchronizes before returning (so the call neither
    waits on nor is ordered against other work).  A stage belongs to one
    thread (`thread_stage`)."""

    def __init__(self, device: torch.device):
        super().__init__(device)
        self.stream = torch.cuda.Stream(device)
        self.stream_ptr = self.stream.cuda_stream


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_THREAD_STAGES = threading.local()


def thread_stage(device) -> CallStage:
    """This thread's own stage on ``device``: the eligibility call runs on
    the shard threads at once and the scan call on the build service's
    worker threads, each on its own buffers and stream.  A thread abandoned
    inside a hung attempt keeps its stage to itself, so the attempts that
    replace it never share its buffers."""
    stages = getattr(_THREAD_STAGES, "stages", None)
    if stages is None:
        stages = _THREAD_STAGES.stages = {}
    key = str(device)
    st = stages.get(key)
    if st is None:
        st = stages[key] = CallStage(_cuda_device(device))
    return st


def scan_call(avail: np.ndarray, plo: int, L: int, Vs: np.ndarray,
              ks: np.ndarray, W: int, reverse: bool = False,
              device="cuda") -> np.ndarray:
    """The scan of one window on the card, from host arrays to host bitmaps.

    avail (m, T, d), the grid: the window is its L live ticks from ``plo``
    (every one counts); Vs (g, d) float32 demands, already ``ceil32``; ks
    (g,) durations.  Returns bool (g, W * m): bit (g, w, machine) says
    whether the run [plo + w, plo + w + ks[g]) fits, starts descending when
    ``reverse``; a run reaching past the window is not good.  One
    ``ps_scan_call``: the window, demands and durations packed into one
    pinned buffer and uploaded at once, the launch writing the bitmaps into
    pinned host memory, one stream synchronize.
    """
    avail = np.ascontiguousarray(avail, dtype=np.float32)
    m, T, d = avail.shape
    g = len(ks)
    vs = np.asarray(Vs, dtype=np.float32).tobytes()
    kb = np.asarray(ks, dtype=np.int32).tobytes()
    off_vs = _align16(m * L * d * 4)
    off_ks = _align16(off_vs + g * d * 4)
    n_out = g * W * m
    st = thread_stage(device)
    st.reserve(off_ks + g * 4, n_out)
    err = lib().ps_scan_call(
        _addr(avail), T * d, plo * d, m, L, d, vs, kb, g, W, int(reverse),
        st.h_in_ptr, st.d_in_ptr, off_vs, off_ks, st.h_out_dev,
        st.stream_ptr)
    _check(err, "scan_bitmaps")
    _count("scan_bitmaps")
    return st.h_out_np[:n_out].reshape(g, W * m).copy()


class ResidentSlot(PinnedBuffers):
    """One in-flight resident scan's `PinnedBuffers` (the slab to upload
    at byte 0 of the input, demands and durations after it; the bitmaps in
    the output) and the event recorded after its launch.  A slot goes back
    to its stage once its bitmaps were copied out or nobody holds them any
    more, and is handed out again only after its event has completed, so
    no buffer is written while a copy or launch still reads it."""

    MIN_BITS = 12

    def __init__(self, device: torch.device):
        super().__init__(device)
        ev = ctypes.c_void_p()
        _check(lib().ps_event_create(ctypes.byref(ev)), "resident scan event")
        self.event = ev.value
        self.pending = False

    def wait(self) -> None:
        """Block until the slot's last launch (and the copies before it on
        the stream) completed."""
        if self.pending:
            _check(lib().ps_event_sync(self.event), "resident scan")
            self.pending = False


class ResidentStage:
    """A thread's resources for resident scans on one device: the stream
    that every mirror made on this thread uploads and scans on (so a scan
    reads its mirror as it was when the scan was issued), and a pool of
    `ResidentSlot` s, one per scan whose bitmaps are still unread.  The pool
    grows when every slot is held and never shrinks; ``slots`` counts the
    slots made."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.stream_ptr = self.stream.cuda_stream
        self._free: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self.slots = 0

    def acquire(self, n_in: int, n_out: int) -> ResidentSlot:
        with self._lock:
            slot = self._free.popleft() if self._free else None
            if slot is None:
                self.slots += 1
        if slot is None:
            slot = ResidentSlot(self.device)
        slot.wait()
        slot.reserve(n_in, n_out)
        return slot

    def release(self, slot: ResidentSlot) -> None:
        with self._lock:
            self._free.append(slot)


_RESIDENT_STAGES = threading.local()


def resident_stage(device) -> ResidentStage:
    """This thread's `ResidentStage` on ``device``."""
    stages = getattr(_RESIDENT_STAGES, "stages", None)
    if stages is None:
        stages = _RESIDENT_STAGES.stages = {}
    key = str(device)
    st = stages.get(key)
    if st is None:
        st = stages[key] = ResidentStage(_cuda_device(device))
    return st


def copy_slab(mirror: torch.Tensor, first: int, S: int, slot: ResidentSlot,
              stage: ResidentStage) -> None:
    """Upload ticks [first, first + S) of every row of ``mirror`` (m, Tb, d)
    float32 on the card from the first m * S * d floats of ``slot``'s
    pinned input, in one strided copy on ``stage``'s stream."""
    m, Tb, d = mirror.shape
    _need(mirror, "mirror", torch.float32, (m, Tb, d), stage.device)
    if first < 0 or first + S > Tb:
        raise ValueError(f"slab [{first}, {first + S}) outside a mirror of "
                         f"{Tb} ticks")
    if m * S * d * 4 > slot.cap_in:
        raise ValueError("slab larger than the slot's input buffer")
    err = lib().ps_copy_slab(mirror.data_ptr(), Tb, first, m, S, d,
                             slot.h_in_ptr, stage.stream_ptr)
    _check(err, "resident scan (slab upload)")


def scan_resident(mirror: torch.Tensor, first: int, L: int, Vs: np.ndarray,
                  ks: np.ndarray, W: int, reverse: bool, off_vs: int,
                  slot: ResidentSlot, stage: ResidentStage) -> None:
    """Launch the scan of ticks [first, first + L) of ``mirror`` (m, Tb, d)
    float32 on the card, every tick live, for demands Vs (g, d) float32
    (already ``ceil32``) and durations ks (g,); returns at once.  The
    bitmaps (g, W, m), starts descending when ``reverse``, land in
    ``slot.h_out_np``, readable after ``slot.wait()``.  Vs and ks are
    packed into the slot's pinned input from byte ``off_vs`` (16-aligned,
    past any slab) and uploaded on ``stage``'s stream before the launch."""
    m, Tb, d = mirror.shape
    g = len(ks)
    _need(mirror, "mirror", torch.float32, (m, Tb, d), stage.device)
    if first < 0 or first + L > Tb or W < 1:
        raise ValueError(f"window [{first}, {first + L}) outside a mirror "
                         f"of {Tb} ticks")
    vs = np.ascontiguousarray(Vs, dtype=np.float32).tobytes()
    kb = np.asarray(ks, dtype=np.int32).tobytes()
    off_ks = _align16(off_vs + g * d * 4)
    if off_ks + g * 4 > slot.cap_in or g * W * m > slot.cap_out:
        raise ValueError("resident scan larger than its slot")
    err = lib().ps_scan_resident(
        mirror.data_ptr(), Tb, first, m, L, d, vs, kb, g, W, int(reverse),
        slot.h_in_ptr, slot.d_in_ptr, off_vs, off_ks, slot.h_out_dev,
        slot.event, stage.stream_ptr)
    _check(err, "scan_bitmaps")
    slot.pending = True
    _count("scan_bitmaps")


def eligible_launch(avail: torch.Tensor, dem: torch.Tensor, slack: float,
                    eps: float, fd_bits: int, rd_bits: int,
                    gd_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The staged call's kernel alone, on device operands: avail (m, d) and
    dem (n, d) float64 -> (eligible (m, n) int8, machine-major;
    machine_any (m,) int8).  ``*_bits``: the fit, rigid and fungible dims
    as bitmasks (d <= 8)."""
    m, d = avail.shape
    n = dem.shape[0]
    dev = avail.device
    _need(avail, "avail", torch.float64, (m, d), dev)
    _need(dem, "dem", torch.float64, (n, d), dev)
    if not 1 <= d <= 8:
        raise ValueError(f"the eligibility call takes 1 <= d <= 8, got {d}")
    out = torch.empty(m * n + m, dtype=torch.int8, device=dev)
    err = lib().ps_eligible_launch(
        _p(avail), _p(dem), m, n, d, float(slack), float(eps), int(fd_bits),
        int(rd_bits), int(gd_bits), _p(out), out[m * n:].data_ptr(),
        _stream(avail))
    _check(err, "heartbeat_eligible")
    _count("heartbeat_eligible")
    return out[:m * n].view(m, n), out[m * n:]


def eligible_call(avail: np.ndarray, dem: np.ndarray, slack: float,
                  eps: float, fd_bits: int, rd_bits: int, gd_bits: int,
                  device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """The matcher's heartbeat eligibility on the card, host arrays in and
    out: avail (m, d) and dem (n, d) float64, the overbooking ``slack``
    (already clamped at 0) and ``eps``, the fit, rigid and fungible dims as
    bitmasks.  Returns (eligible (n, m) bool, machine_any (m,) bool), the
    sound superset of ``ref.heartbeat_eligible64``; ``eligible`` is the
    transposed view of a machine-major copy, so a machine's column
    (``eligible[:, mm]``, what the waves read) is contiguous.  One
    ``ps_eligible_call``: one pinned upload, one launch writing into pinned
    host memory, one synchronize, on this thread's stage."""
    avail = np.ascontiguousarray(avail, dtype=np.float64)
    dem = np.ascontiguousarray(dem, dtype=np.float64)
    m, d = avail.shape
    n = dem.shape[0]
    if dem.shape[1] != d:
        raise ValueError(f"dem has {dem.shape[1]} dims, avail {d}")
    if not 1 <= d <= 8:
        raise ValueError(f"the eligibility call takes 1 <= d <= 8, got {d}")
    off_dem = _align16(m * d * 8)
    off_any = _align16(m * n)
    st = thread_stage(device)
    st.reserve(off_dem + n * d * 8, off_any + m)
    err = lib().ps_eligible_call(
        _addr(avail), _addr(dem), m, n, d, float(slack), float(eps),
        int(fd_bits), int(rd_bits), int(gd_bits), st.h_in_ptr, st.d_in_ptr,
        off_dem, st.h_out_dev, off_any, st.stream_ptr)
    _check(err, "heartbeat_eligible")
    _count("heartbeat_eligible")
    return unpack_eligible(st.h_out_np, m, n, off_any)


def unpack_eligible(buf: np.ndarray, m: int, n: int,
                    off_any: int) -> tuple[np.ndarray, np.ndarray]:
    """The staged call's results copied out of its bool output buffer:
    ``eligible`` (machine-major (m, n) at byte 0) as its (n, m) transposed
    view, ``machine_any`` (m,) from byte ``off_any``.  Copies, never views:
    the next call on the stage overwrites the buffer."""
    return (buf[:m * n].reshape(m, n).copy().T,
            buf[off_any:off_any + m].copy())


def heartbeat_eligible(dem32: torch.Tensor, thr_fit: torch.Tensor,
                       thr_fung: torch.Tensor, fd_mask: torch.Tensor,
                       rd_mask: torch.Tensor,
                       gd_mask: torch.Tensor) -> torch.Tensor:
    """dem32 (n, d); thr_* (m, d); masks (d,) f32 {0,1} -> (n, m) int8."""
    n, d = dem32.shape
    m = thr_fit.shape[0]
    dev = dem32.device
    _need(dem32, "dem32", torch.float32, (n, d), dev)
    _need(thr_fit, "thr_fit", torch.float32, (m, d), dev)
    _need(thr_fung, "thr_fung", torch.float32, (m, d), dev)
    for name, mk in (("fd_mask", fd_mask), ("rd_mask", rd_mask),
                     ("gd_mask", gd_mask)):
        _need(mk, name, torch.float32, (d,), dev)
    out = torch.empty((n, m), dtype=torch.int8, device=dev)
    err = lib().ps_heartbeat_eligible(_p(dem32), _p(thr_fit), _p(thr_fung),
                                      _p(fd_mask), _p(rd_mask), _p(gd_mask),
                                      n, m, d, _p(out), _stream(dem32))
    _check(err, "heartbeat_eligible")
    _count("heartbeat_eligible")
    return out


def match_wave_walk(avail, order, dem, pri, srpt, gidx, loc, taken0, ema,
                    deficit, share, fd_mask, rd_mask, fg_mask, consts, *,
                    bundle_limit: int, use_packing: bool, use_srpt: bool,
                    use_overbooking: bool, drf: bool):
    """One heartbeat wave in one CTA; same contract as ``ref.match_wave_walk``.

    Returns (avail', ema', deficit', rows, machines, over, obs, count) as
    new tensors: the inputs are left untouched.
    """
    m, d = avail.shape
    n = dem.shape[0]
    G = deficit.shape[0]
    dev = avail.device
    f64, i32 = torch.float64, torch.int32
    _need(avail, "avail", f64, (m, d), dev)
    _need(order, "order", i32, (m,), dev)
    _need(dem, "dem", f64, (n, d), dev)
    for name, t in (("pri", pri), ("srpt", srpt)):
        _need(t, name, f64, (n,), dev)
    for name, t in (("gidx", gidx), ("loc", loc)):
        _need(t, name, i32, (n,), dev)
    _need(taken0, "taken0", torch.bool, (n,), dev)
    _need(ema, "ema", f64, (2,), dev)
    _need(deficit, "deficit", f64, (G,), dev)
    _need(share, "share", f64, (G,), dev)
    for name, mk in (("fd_mask", fd_mask), ("rd_mask", rd_mask),
                     ("fg_mask", fg_mask)):
        _need(mk, name, torch.bool, (d,), dev)
    _need(consts, "consts", f64, (8,), dev)
    if not 1 <= d <= 8 or G < 1:
        raise ValueError(f"match_wave_walk takes 1 <= d <= 8 and G >= 1, "
                         f"got d={d} G={G}")
    avail_o = avail.clone()
    ema_o = ema.clone()
    deficit_o = deficit.clone()
    masks = torch.cat([fd_mask, rd_mask, fg_mask])
    # the pick outputs as views of one zeroed buffer (one launch, not five):
    # obs (8n bytes), rows (4n), machines (4n), count (4), over (n)
    out = torch.zeros(17 * n + 4, dtype=torch.uint8, device=dev)
    obs = out[:8 * n].view(f64)
    rows = out[8 * n:12 * n].view(i32)
    mach = out[12 * n:16 * n].view(i32)
    cnt = out[16 * n:16 * n + 4].view(i32)
    over = out[16 * n + 4:].view(torch.int8)
    flags = ((F_PACKING if use_packing else 0) | (F_SRPT if use_srpt else 0)
             | (F_OVERBOOK if use_overbooking else 0) | (F_DRF if drf else 0))
    err = lib().ps_match_wave(
        _p(avail_o), _p(order), m, _p(dem), _p(pri), _p(srpt), _p(gidx),
        _p(loc), _p(taken0), n, _p(ema_o), _p(deficit_o), _p(share), G,
        _p(masks), _p(consts), d, int(bundle_limit), flags, _p(rows),
        _p(mach), _p(over), _p(obs), _p(cnt), _stream(avail))
    _check(err, "match_wave_walk")
    _count("match_wave_walk")
    return avail_o, ema_o, deficit_o, rows, mach, over, obs, cnt[0]
