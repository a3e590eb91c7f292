"""RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + x_t`` per channel.

  ref.py    — plain PyTorch version and its backward (sequential loops,
              any device)
  kernel.py — build, ctypes binding and launch counter of csrc/rg_lru.cu
  ops.py    — entry point (an autograd Function under grad): the kernel
              for CUDA tensors, the plain version for CPU tensors (or on
              the card under the explicit pin of ``kernels/pin.py``)
"""

from . import ops, ref  # noqa: F401
