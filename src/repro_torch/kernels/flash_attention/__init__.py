"""Flash attention: tiled online-softmax GQA attention with causal and
sliding-window masks and a tanh logit soft-cap.

  ref.py    — plain PyTorch version and its backward (naive full-matrix
              softmax and its gradient, any device)
  kernel.py — build, ctypes binding and launch counter of
              csrc/flash_attention.cu
  ops.py    — entry point (an autograd Function under grad): the kernel
              for CUDA tensors, the plain version for CPU tensors (or on
              the card under the explicit pin of ``kernels/pin.py``)
"""

from . import ops, ref  # noqa: F401
