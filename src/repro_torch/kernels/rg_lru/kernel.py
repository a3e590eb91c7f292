"""Build, bind and launch the RG-LRU scan kernels (``csrc/rg_lru.cu``):
the forward and its backward (the reverse recurrence).

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

_SRC = Path(__file__).resolve().parent / "csrc" / "rg_lru.cu"

#: launches since the last `reset_launches` (the wrapper is the only writer)
LAUNCHES = {"rglru_scan": 0, "rglru_scan_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _bind(handle: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    handle.rglru_scan.argtypes = [vp, vp, vp, vp, vp, i, i, i, vp]
    handle.rglru_scan.restype = ctypes.c_int
    handle.rglru_scan_bwd.argtypes = [vp] * 8 + [i, i, i, vp]
    handle.rglru_scan_bwd.restype = ctypes.c_int


#: the step is spelled __fadd_rn(__fmul_rn(a, h), x): no flag needed
LIBRARY = NvccLibrary("rg_lru", _SRC, (), _bind)
build = LIBRARY.build
lib = LIBRARY.lib


def rglru_scan(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
    """x, a (B, S, D) f32; h0 (B, D) f32 -> (y (B, S, D) f32, hT (B, D) f32).

    Same contract as ``ref.rglru_scan``; the kernel takes float32 only (the
    model computes its gates in float32)."""
    B, S, D = x.shape
    dev = x.device
    need(x, "x", torch.float32, (B, S, D), dev)
    need(a, "a", torch.float32, (B, S, D), dev)
    need(h0, "h0", torch.float32, (B, D), dev)
    y = torch.empty_like(x)
    hT = torch.empty_like(h0)
    if B == 0 or D == 0:
        return y, hT
    err = lib().rglru_scan(ptr(x), ptr(a), ptr(h0), ptr(y), ptr(hT), B, S, D,
                           stream(x))
    check_launch(err, "rglru_scan")
    LAUNCHES["rglru_scan"] += 1
    return y, hT


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                   dh: torch.Tensor, dhT: torch.Tensor | None = None):
    """Same contract as ``ref.rglru_scan_bwd``: a, h (the forward's output),
    dh (B, S, D) f32; h0 and dhT (or None) (B, D) f32 -> (dx, da (B, S, D),
    dh0 (B, D)), all float32, bitwise equal to the plain reverse loop."""
    B, S, D = a.shape
    dev = a.device
    need(a, "a", torch.float32, (B, S, D), dev)
    need(h, "h", torch.float32, (B, S, D), dev)
    need(dh, "dh", torch.float32, (B, S, D), dev)
    need(h0, "h0", torch.float32, (B, D), dev)
    if dhT is not None:
        need(dhT, "dhT", torch.float32, (B, D), dev)
    dx, da = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    if B == 0 or D == 0 or S == 0:
        return dx, da, (dh0.copy_(dhT) if dhT is not None else dh0.zero_())
    err = lib().rglru_scan_bwd(ptr(a), ptr(h), ptr(h0), ptr(dh),
                               ptr(dhT) if dhT is not None else None,
                               ptr(dx), ptr(da), ptr(dh0), B, S, D, stream(a))
    check_launch(err, "rglru_scan_bwd")
    LAUNCHES["rglru_scan_bwd"] += 1
    return dx, da, dh0
