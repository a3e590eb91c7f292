"""Build, bind and launch the flash-attention kernels
(``csrc/flash_attention.cu``): the forward (the Hopper kernel, TMA and
wgmma, for bfloat16; the CUDA-core kernel for float32), optionally writing
each row's log-sum-exp, and the backward (three launches, a fourth summing
dK and dV over each KV head's group under GQA/MQA: Hopper kernels on TMA
and wgmma for bfloat16, CUDA-core kernels for float32).

The wrapper checks device, dtype, shape, contiguity and alignment, launches
on PyTorch's current stream, raises if ``cudaGetLastError`` reports a
refused launch (too much shared memory, a bad grid), and adds one to
``LAUNCHES`` (one for a forward call, one for a backward call of three or
four launches).  Nothing is compiled until a wrapper runs on a CUDA tensor
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
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _bind(handle: ctypes.CDLL) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    handle.flash_attention_fwd.argtypes = ([vp] * 4 + [i] * 6 + [i, i, i]
                                           + [f, f, vp, vp])
    handle.flash_attention_fwd.restype = ctypes.c_int
    handle.flash_attention_bwd.argtypes = ([vp] * 11 + [i] * 6 + [i, i, i]
                                           + [f, f, i, vp])
    handle.flash_attention_bwd.restype = ctypes.c_int
    handle.flash_wgmma_probe.argtypes = [vp] * 6
    handle.flash_wgmma_probe.restype = ctypes.c_int


#: plain IEEE math (expf, tanhf, division); FMAs are allowed
LIBRARY = NvccLibrary("flash_attention", _SRC, (), _bind)
build = LIBRARY.build
lib = LIBRARY.lib


def _check(q, k, v, window, cap) -> None:
    """The operands' contract, shared by the forward and the backward."""
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    cap: float | None = None, scale: float | None = None,
                    return_lse: bool = False):
    """Same contract as ``ref.attention``.  q (B, Sq, H, hd), k and v
    (B, Sk, KV, hd), all float32 or all bfloat16; H a multiple of KV;
    hd <= 256 (and a multiple of 16 for bfloat16).  ``return_lse`` also
    returns each row's log-sum-exp (B, H, Sq) float32, which the backward
    reads; without it the kernel writes none."""
    _check(q, k, v, window, cap)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B and Sq and H:
        scale = scale if scale is not None else 1.0 / math.sqrt(hd)
        err = lib().flash_attention_fwd(
            ptr(q), ptr(k), ptr(v), ptr(out), B, Sq, Sk, H, KV, hd,
            _DTYPES[q.dtype], int(bool(causal)), int(window or 0),
            float(scale), float(cap or 0.0),
            ptr(lse) if return_lse else None, stream(q))
        check_launch(err, "flash_attention")
        LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        cap: float | None = None,
                        scale: float | None = None, parts: int = 7):
    """Same contract as ``ref.attention_bwd``: the forward's operands, its
    output ``o`` and ``lse`` and the output's gradient ``do`` (like q) ->
    (dq, dk, dv) in the operands' dtype, dk and dv summed over each KV
    head's group of query heads (under GQA/MQA through float32 partials of
    each query head, 2 x B x Sk x H x hd scratch, summed in head order).
    ``parts`` is for timing the launches apart: a mask of those to make (1
    the D pre-pass, 2 dK and dV with their group sum, 4 dQ); the outputs a
    launch left out does not write are undefined.  For bfloat16 the
    kernels round P and dS to bfloat16 before their products, as
    ``ref.attention_bwd(..., tile_dtype=torch.bfloat16)`` does; every sum
    is float32, and two calls give the same bits (no atomics)."""
    if not 1 <= parts <= 7:
        raise ValueError(f"parts must be a mask in 1..7, got {parts}")
    _check(q, k, v, window, cap)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    need(o, "o", q.dtype, (B, Sq, H, hd), q.device)
    need(do, "do", q.dtype, (B, Sq, H, hd), q.device)
    need(lse, "lse", torch.float32, (B, H, Sq), q.device)
    if do.data_ptr() % 16:
        raise ValueError("flash_attention_bwd needs a 16-byte aligned do")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not (B and Sq and H):
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    part = (torch.empty((2, B, Sk, H, hd), dtype=torch.float32,
                        device=q.device) if H != KV else None)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    err = lib().flash_attention_bwd(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse), ptr(delta),
        ptr(dq), ptr(dk), ptr(dv), None if part is None else ptr(part),
        B, Sq, Sk, H, KV, hd, _DTYPES[q.dtype],
        int(bool(causal)), int(window or 0), float(scale), float(cap or 0.0),
        int(parts), stream(q))
    check_launch(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


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
