"""RWKV6 (Finch) WKV recurrence with data-dependent decay, per (batch, head).

  ref.py    — plain PyTorch version (sequential loop over time, any device)
  kernel.py — build, ctypes binding and launch counter of csrc/wkv6.cu
  ops.py    — entry point: the kernel for CUDA tensors, the plain version
              for CPU tensors (or on the card under the explicit pin of
              ``kernels/pin.py``)
"""

from . import ops, ref  # noqa: F401
