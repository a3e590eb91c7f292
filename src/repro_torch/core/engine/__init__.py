"""Placement engine: backend-abstracted, candidate-parallel placement core.

Layers:
  base      — PlacementBackend/PlacementSession protocol + registry
  kernels   — kernel-dispatch layer: cuda / torch / numpy implementations
              of the scan + fit/score/heartbeat/wave ops, selected per-op
  reference — per-task numpy grid search (the semantic oracle)
  batched   — windowed ready-set feasibility scan, (n_tasks, m, W) lift
  jit       — batched placement scanning a grid mirror resident on the
              session's device, launched asynchronously
  packing   — shared numpy fit/score kernels for the online layers

Select backends with ``build_schedule(..., backend="batched")`` or the
``REPRO_PLACEMENT_BACKEND`` env var; pin kernel implementations with
``REPRO_KERNELS`` (e.g. ``scan=numpy``).
"""

from .base import (BACKEND_ENV, BACKWARD, DEFAULT_BACKEND, FORWARD, PeerTask,
                   PlacementBackend, PlacementSession, available_backends,
                   get_backend, register_backend)
from . import kernels
from .kernels import scan_starts
from .reference import ReferenceBackend
from .batched import BatchedBackend
from .jit import JitBackend
from . import packing

__all__ = [
    "BACKEND_ENV", "BACKWARD", "DEFAULT_BACKEND", "FORWARD", "PeerTask",
    "PlacementBackend", "PlacementSession", "available_backends",
    "get_backend", "register_backend", "ReferenceBackend", "BatchedBackend",
    "JitBackend",
    "scan_starts", "packing", "kernels",
]
