"""Placement-scan ops: windowed feasibility scan, heartbeat eligibility and
the fused heartbeat wave.

  ref.py    — plain PyTorch versions (any device)
  kernel.py — build, ctypes binding and launch counters of the CUDA kernels
              in csrc/placement_scan.cu
  ops.py    — entry points: the kernel for CUDA tensors, the plain version
              for CPU tensors

Registered as the ``cuda`` and ``torch`` implementations of the ``scan``,
``machines_with_candidates`` and ``match_wave`` ops in
``core/engine/kernels.py``.
"""

from . import ops, ref  # noqa: F401
