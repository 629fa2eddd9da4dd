"""Hand-written CUDA kernels (csrc/) and their wrappers.

Each wrapper takes its kernel's plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors; anything else (wrong dtype, shape or
contiguity) raises. K12 (binning.py) is the exception: its plain version is
the slot path of ops/binning.py, which ``bin_gaussians`` takes itself, so
its wrapper takes CUDA tensors only. Each wrapper counts its kernel
launches in a plain integer attribute, ``<wrapper>.launches``.
"""
