"""PyTorch/CUDA port of the DAGPS scheduler (the package beside ``repro``).

Host control logic is numpy with the reference semantics; the three
kernels of the main path (feasibility scan, heartbeat eligibility, fused
heartbeat wave) are hand-written CUDA in ``kernels/placement_scan``.
Entry points take ``device=`` ("cuda" by default, "cpu" for the plain
torch versions) and never fall back to the CPU on their own.
"""
