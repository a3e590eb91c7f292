"""Hand-written CUDA kernels of the port, one package per op family:
  ref.py  — plain PyTorch version (CPU tests, on-card comparison)
  kernel.py + csrc/ — the CUDA kernel, its build and its binding
  ops.py  — entry point: kernel for CUDA tensors, plain version for CPU
"""
