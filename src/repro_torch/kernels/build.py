"""Build and load one kernel family's CUDA source as a plain C library.

Each family (``placement_scan``, ``flash_attention``, ``rg_lru``,
``rwkv6``) keeps its source under ``csrc/`` and its own ``nvcc`` flags.
`NvccLibrary` compiles the source at first use into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) and loads
it with ``ctypes``.  The library lands in ``build/repro_torch_kernels/`` at the
repository root (override with ``REPRO_TORCH_BUILD_DIR``), named by a hash
of the source and the flags, so an edited source rebuilds and an unchanged
one loads the cached build.  Nothing is compiled until a wrapper runs on a
CUDA tensor or a caller asks for `NvccLibrary.build`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Callable

import torch

_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"
#: flags every family shares; each adds its own (e.g. ``-fmad=false``)
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def build_dir() -> Path:
    raw = os.environ.get(BUILD_DIR_ENV, "")
    return Path(raw) if raw else _ROOT / "build" / "repro_torch_kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "source with the CUDA toolkit")


class NvccLibrary:
    """One ``.cu`` source, its flags, and the ``ctypes`` binding of its
    exported functions (``bind`` sets ``argtypes``/``restype``)."""

    def __init__(self, name: str, src: Path, flags: tuple[str, ...],
                 bind: Callable[[ctypes.CDLL], None]):
        self.name, self.src, self.bind = name, Path(src), bind
        self.flags = BASE_FLAGS + tuple(flags)
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        digest = hashlib.sha256(self.src.read_bytes()
                                + " ".join(self.flags).encode()).hexdigest()
        return build_dir() / f"lib{self.name}_{digest[:16]}.so"

    def build(self, verbose: bool = False) -> Path:
        """Compile the library if no build of this source exists yet."""
        out = self.path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = [nvcc(), *self.flags]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(self.src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.src.name} "
                               f"({proc.returncode}):\n{proc.stderr}")
        if verbose and proc.stderr:
            print(proc.stderr, file=sys.stderr)
        os.replace(tmp, out)
        return out

    def lib(self) -> ctypes.CDLL:
        """The loaded library (built on first call)."""
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                handle = ctypes.CDLL(str(self.build()))
                self.bind(handle)
                self._lib = handle
        return self._lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_launch(err: int, name: str) -> None:
    """Raise if the C side reported a nonzero ``cudaGetLastError``."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def need(t: torch.Tensor, name: str, dtype, shape: tuple,
         device: torch.device) -> None:
    """Check one operand's device, dtype (or tuple of dtypes), shape and
    contiguity before its pointer goes to a kernel."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    ok = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in ok:
        raise TypeError(f"{name} has dtype {t.dtype}, expected "
                        f"{' or '.join(str(d) for d in ok)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
