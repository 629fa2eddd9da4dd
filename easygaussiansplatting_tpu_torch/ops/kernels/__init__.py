"""Hand-written CUDA kernels (csrc/) and their wrappers.

Each wrapper takes its kernel's plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors; anything else (wrong dtype, shape or
contiguity) raises. Each wrapper counts its kernel launches in a plain
integer attribute, ``<wrapper>.launches``.
"""
