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
(`ScanStage`) are made once and reused.
"""

from __future__ import annotations

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
    handle.ps_host_device_ptr.argtypes = [vp, ctypes.POINTER(vp)]
    handle.ps_heartbeat_eligible.argtypes = [vp] * 6 + [i, i, i, vp, vp]
    handle.ps_match_wave.argtypes = (
        [vp, vp, i, vp, vp, vp, vp, vp, vp, i, vp, vp, vp, i, vp, vp,
         i, i, i, vp, vp, vp, vp, vp, vp])
    for fn in (handle.ps_scan_bitmaps, handle.ps_scan_call,
               handle.ps_host_device_ptr, handle.ps_heartbeat_eligible,
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
    LAUNCHES["scan_bitmaps"] += 1
    return out


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _addr(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


class ScanStage:
    """The staged scan call's resources on one device: a pinned host buffer
    for the packed inputs and its device twin, a pinned host buffer the
    kernel writes the bitmaps into (and the card's address of it), and a
    stream of the call's own, which it synchronizes before returning (so
    the call neither waits on nor is ordered against other work).  The
    buffers grow to the next power of two when a call needs more and are
    reused otherwise; a lock keeps one call at a time on them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self.stream = torch.cuda.Stream(device)
        self.stream_ptr = self.stream.cuda_stream
        self.cap_in = self.cap_out = 0

    def reserve(self, n_in: int, n_out: int) -> None:
        if n_in > self.cap_in:
            self.cap_in = 1 << max(16, (n_in - 1).bit_length())
            self.h_in = torch.empty(self.cap_in, dtype=torch.uint8,
                                    pin_memory=True)
            self.d_in = torch.empty(self.cap_in, dtype=torch.uint8,
                                    device=self.device)
            self.h_in_ptr = self.h_in.data_ptr()
            self.d_in_ptr = self.d_in.data_ptr()
        if n_out > self.cap_out:
            self.cap_out = 1 << max(16, (n_out - 1).bit_length())
            self.h_out = torch.empty(self.cap_out, dtype=torch.uint8,
                                     pin_memory=True)
            self.h_out_np = self.h_out.numpy().view(bool)
            dev = ctypes.c_void_p()
            _check(lib().ps_host_device_ptr(self.h_out.data_ptr(),
                                            ctypes.byref(dev)),
                   "scan_bitmaps (pinned output)")
            self.h_out_dev = dev.value


_STAGES: dict[str, ScanStage] = {}


def stage_for(device) -> ScanStage:
    key = str(device)
    st = _STAGES.get(key)
    if st is None:
        dev = torch.device(device)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        st = _STAGES.setdefault(key, ScanStage(dev))
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
    st = stage_for(device)
    with st.lock:
        st.reserve(off_ks + g * 4, n_out)
        err = lib().ps_scan_call(
            _addr(avail), T * d, plo * d, m, L, d, vs, kb, g, W, int(reverse),
            st.h_in_ptr, st.d_in_ptr, off_vs, off_ks, st.h_out_dev,
            st.stream_ptr)
        _check(err, "scan_bitmaps")
        LAUNCHES["scan_bitmaps"] += 1
        return st.h_out_np[:n_out].reshape(g, W * m).copy()


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
    LAUNCHES["heartbeat_eligible"] += 1
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
    LAUNCHES["match_wave_walk"] += 1
    return avail_o, ema_o, deficit_o, rows, mach, over, obs, cnt[0]
