"""Build, bind and launch the flash-attention kernel
(``csrc/flash_attention.cu``): the Hopper kernel (TMA, wgmma) for
bfloat16, the CUDA-core kernel for float32.

The wrapper checks device, dtype, shape, contiguity and alignment, launches
on PyTorch's current stream, raises if ``cudaGetLastError`` reports a
refused launch (too much shared memory, a bad grid), and adds one to
``LAUNCHES``.  Nothing is compiled until a wrapper runs on a CUDA tensor
(``kernels/build.py``).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ..build import NvccLibrary, check_launch, need, ptr, stream

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
#: the bf16 kernel pads hd to 64, 128 or 256 columns (four TMA boxes at most)
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches since the last `reset_launches` (the wrapper is the only writer)
LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _bind(handle: ctypes.CDLL) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    handle.flash_attention_fwd.argtypes = ([vp] * 4 + [i] * 6 + [i, i, i]
                                           + [f, f, vp])
    handle.flash_attention_fwd.restype = ctypes.c_int
    handle.flash_wgmma_probe.argtypes = [vp] * 6
    handle.flash_wgmma_probe.restype = ctypes.c_int


#: plain IEEE math (expf, tanhf, division); FMAs are allowed
LIBRARY = NvccLibrary("flash_attention", _SRC, (), _bind)
build = LIBRARY.build
lib = LIBRARY.lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    cap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Same contract as ``ref.attention``.  q (B, Sq, H, hd), k and v
    (B, Sk, KV, hd), all float32 or all bfloat16; H a multiple of KV;
    hd <= 256 (and a multiple of 16 for bfloat16)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dev = q.device
    need(q, "q", tuple(_DTYPES), (B, Sq, H, hd), dev)
    need(k, "k", q.dtype, (B, Sk, KV, hd), dev)
    need(v, "v", q.dtype, (B, Sk, KV, hd), dev)
    if KV < 1 or H % KV != 0:
        raise ValueError(f"flash_attention needs H % KV == 0, got H={H} KV={KV}")
    if not 1 <= hd <= MAX_HEAD_DIM or (q.dtype == torch.bfloat16
                                       and hd % 16 != 0):
        raise ValueError(f"flash_attention takes hd <= {MAX_HEAD_DIM} (a "
                         f"multiple of 16 for bfloat16), got hd={hd}")
    if Sk < 1:
        raise ValueError("flash_attention needs at least one key")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if cap is not None and not cap > 0:
        raise ValueError(f"cap must be > 0, got {cap}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned q, k, v")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0 or H == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    err = lib().flash_attention_fwd(
        ptr(q), ptr(k), ptr(v), ptr(out), B, Sq, Sk, H, KV, hd,
        _DTYPES[q.dtype], int(bool(causal)), int(window or 0), float(scale),
        float(cap or 0.0), stream(q))
    check_launch(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def wgmma_probe(a: torch.Tensor, b: torch.Tensor,
                v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two products alone, for testing its layouts: a (64, 64),
    b (64, 64), v (64, 256) bfloat16 on the card -> (a @ b.T, a @ v) in
    float32, through wgmma.m64n64k16 with both operands K-major and
    wgmma.m64n256k16 with a in registers and v MN-major, from the same
    128-byte swizzled TMA boxes and descriptors as the attention kernel.
    Not an attention launch: ``LAUNCHES`` does not count it."""
    dev = a.device
    need(a, "a", torch.bfloat16, (64, 64), dev)
    need(b, "b", torch.bfloat16, (64, 64), dev)
    need(v, "v", torch.bfloat16, (64, 256), dev)
    s = torch.empty((64, 64), dtype=torch.float32, device=dev)
    o = torch.empty((64, 256), dtype=torch.float32, device=dev)
    err = lib().flash_wgmma_probe(ptr(a), ptr(b), ptr(v), ptr(s), ptr(o),
                                  stream(a))
    check_launch(err, "flash_wgmma_probe")
    return s, o
