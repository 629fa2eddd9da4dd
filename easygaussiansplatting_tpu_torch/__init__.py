"""easygaussiansplatting_tpu_torch — the PyTorch / CUDA port of
easygaussiansplatting_tpu.

The JAX package beside this one is the reference; this package mirrors its
module names (``ops/stages.py`` <-> ``ops/stages.py`` and so on) and holds
the same outputs and contracts. Every Pallas kernel on a ported path becomes
a hand-written CUDA kernel for Hopper (``csrc/``), built with ``nvcc`` at
first use and bound through ``ctypes`` (``ops/kernels/_build.py``). Each
kernel keeps a plain PyTorch version beside it: a wrapper takes the plain
version for CPU tensors and launches the kernel for CUDA tensors.

Ported so far (the forward render path and the single-camera training
step):
  utils/{sh,activations,quaternion,schedule}.py, models/camera.py,
  models/gaussians.py, models/convert.py, data/fixtures.py,
  data/synthetic.py, data/gau_io.py (load side), ops/stages.py,
  ops/binning.py, ops/blend.py, ops/rasterize_tiled.py, ops/rasterize.py,
  ops/loss.py, ops/kernels/{preprocess,scan,rasterize}.py,
  train/{config,optimizer,density,loop}.py, render.py (CLI).

This package never imports jax nor easygaussiansplatting_tpu; only the tests
import both.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
