"""Build, bind and launch the WKV6 kernels (``csrc/wkv6.cu``): the forward
and its backward (the reverse recurrence).

The wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, raises if ``cudaGetLastError`` reports a refused
launch, and adds one to ``LAUNCHES``.  Nothing is compiled until a wrapper
runs on a CUDA tensor (``kernels/build.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import NvccLibrary, check_launch, need, ptr, stream

_SRC = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
#: head widths the kernel is instantiated for
HEAD_SIZES = (16, 32, 64)

#: launches since the last `reset_launches` (the wrapper is the only writer)
LAUNCHES = {"wkv6": 0, "wkv6_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _bind(handle: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    handle.wkv6_fwd.argtypes = [vp] * 8 + [i] * 5 + [vp]
    handle.wkv6_fwd.restype = ctypes.c_int
    handle.wkv6_bwd.argtypes = [vp] * 16 + [i] * 5 + [vp]
    handle.wkv6_bwd.restype = ctypes.c_int
    handle.wkv6_bwd_ckpt_floats.argtypes = [i] * 4
    handle.wkv6_bwd_ckpt_floats.restype = ctypes.c_longlong


#: the sum over i runs in another order than the plain version's, so FMA
#: contraction costs nothing the tolerance does not already allow
LIBRARY = NvccLibrary("wkv6", _SRC, (), _bind)
build = LIBRARY.build
lib = LIBRARY.lib


def _check(r, k, v, w, u, state):
    """The operands' contract, shared by the forward and the backward:
    returns (B, S, H, N)."""
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, N), got {tuple(r.shape)}")
    B, S, H, N = r.shape
    if N not in HEAD_SIZES:
        raise ValueError(f"head size {N} is not one of {HEAD_SIZES}")
    if S < 1:
        raise ValueError("wkv6 needs at least one timestep")
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"the wkv6 kernel runs on cuda tensors, not {dev}")
    dt = (torch.bfloat16, torch.float32)
    need(r, "r", dt, (B, S, H, N), dev)
    need(k, "k", r.dtype, (B, S, H, N), dev)
    need(v, "v", r.dtype, (B, S, H, N), dev)
    need(w, "w", torch.float32, (B, S, H, N), dev)
    need(u, "u", torch.float32, (H, N), dev)
    need(state, "state", torch.float32, (B, H, N, N), dev)
    return B, S, H, N


def _aligned(*ts):
    """The kernels read 16-byte units: a view that starts off that grain
    (a rare storage offset) is copied to a fresh, aligned tensor."""
    return tuple(t if t is None or t.data_ptr() % 16 == 0 else t.clone()
                 for t in ts)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor):
    """Same contract as ``ref.wkv6``.  r, k, v (B, S, H, N), all bfloat16 or
    all float32; w (B, S, H, N), u (H, N) and state (B, H, N, N) float32;
    N in `HEAD_SIZES`; any S >= 1."""
    B, S, H, N = _check(r, k, v, w, u, state)
    r, k, v, w, state = _aligned(r, k, v, w, state)
    y = torch.empty_like(r)
    sT = torch.empty_like(state)
    if B == 0 or H == 0:
        return y, sT
    err = lib().wkv6_fwd(ptr(r), ptr(k), ptr(v), ptr(w), ptr(u), ptr(state),
                         ptr(y), ptr(sT), B, S, H, N,
                         int(r.dtype == torch.bfloat16), stream(r))
    check_launch(err, "wkv6")
    LAUNCHES["wkv6"] += 1
    return y, sT


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
             dy: torch.Tensor, dsT: torch.Tensor | None = None):
    """Same contract as ``ref.wkv6_bwd``: the forward's operands (as
    `wkv6` takes them), dy (B, S, H, N) in r's dtype and dsT (B, H, N, N)
    float32 or None -> (dr, dk, dv, dw (B, S, H, N), du (H, N), ds0 (B, H,
    N, N)), all float32, within float32 rounding of the plain version
    (``ref.f32_bwd_error_bound``; its summation order is
    ``ref.wkv6_bwd_tiled``'s); two calls agree bitwise.  Each (b, h) runs
    as a thread-block cluster of N / 32 CTAs (one below N = 64).  Scratch:
    every sixteenth state of the forward pass, B H ceil(S / 16) N^2
    floats."""
    B, S, H, N = _check(r, k, v, w, u, state)
    need(dy, "dy", r.dtype, (B, S, H, N), r.device)
    if dsT is not None:
        need(dsT, "dsT", torch.float32, (B, H, N, N), r.device)
    r, k, v, w, state, dy, dsT = _aligned(r, k, v, w, state, dy, dsT)
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv, dw = (torch.empty((B, S, H, N), **f32) for _ in range(4))
    du = torch.zeros((H, N), **f32)
    ds0 = torch.empty((B, H, N, N), **f32)
    if B == 0 or H == 0:
        return dr, dk, dv, dw, du, ds0
    ckpt = torch.empty(lib().wkv6_bwd_ckpt_floats(B, S, H, N), **f32)
    du_part = torch.empty((B, H, N), **f32)
    err = lib().wkv6_bwd(ptr(r), ptr(k), ptr(v), ptr(w), ptr(u), ptr(state),
                         ptr(dy), ptr(dsT) if dsT is not None else None,
                         ptr(dr), ptr(dk), ptr(dv), ptr(dw), ptr(du),
                         ptr(ds0), ptr(ckpt), ptr(du_part), B, S, H, N,
                         int(r.dtype == torch.bfloat16), stream(r))
    check_launch(err, "wkv6_bwd")
    LAUNCHES["wkv6_bwd"] += 1
    return dr, dk, dv, dw, du, ds0
