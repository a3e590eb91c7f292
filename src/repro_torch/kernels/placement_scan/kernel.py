"""Build, bind and launch the placement-scan CUDA kernels.

``csrc/placement_scan.cu`` is compiled with ``nvcc -fmad=false`` at first
use into a shared library with a plain C interface and loaded through
``ctypes`` (``kernels/build.py``).

Each wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, raises if ``cudaGetLastError`` reports a refused
launch, and adds one to its entry in ``LAUNCHES``.  Nothing here is
imported or compiled until a wrapper runs on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

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
    handle.ps_scan_bitmaps.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp, vp]
    handle.ps_heartbeat_eligible.argtypes = [vp] * 6 + [i, i, i, vp, vp]
    handle.ps_match_wave.argtypes = (
        [vp, vp, i, vp, vp, vp, vp, vp, vp, i, vp, vp, vp, i, vp, vp,
         i, i, i, vp, vp, vp, vp, vp, vp])
    for fn in (handle.ps_scan_bitmaps, handle.ps_heartbeat_eligible,
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
