"""easygaussiansplatting_tpu_torch — the PyTorch / CUDA port of
easygaussiansplatting_tpu.

The JAX package beside this one is the reference; this package mirrors its
module names (``ops/stages.py`` <-> ``ops/stages.py`` and so on) and holds
the same outputs and contracts. Every Pallas kernel on a ported path becomes
a hand-written CUDA kernel for Hopper (``csrc/``), built with ``nvcc`` at
first use and bound through ``ctypes`` (``ops/kernels/_build.py``). Each
kernel keeps a plain PyTorch version beside it: a wrapper takes the plain
version for CPU tensors and launches the kernel for CUDA tensors.

Ported (the forward render, the training step, the epoch loop, the
gradient gate, eval, COLMAP scenes from photos on disk, the time-to-PSNR
benchmark, the viewer, multi-device training on torch.distributed, the
entry points of __graft_entry__.py, and every Pallas kernel of the
repository):
  utils/{sh,activations,quaternion,schedule,image,envflag,device,gif}.py,
  models/{camera,gaussians,convert}.py, data/{fixtures,synthetic,gau_io}.py,
  data/{colmap,native_loader,image_io,dataset}.py (with native/png_unfilter.cc,
  csrc/nvjpeg_decode.cpp and the data/io_fixtures/ of make_io_fixtures.py),
  ops/{stages,binning,blend,rasterize_tiled,rasterize,rasterize_ref,loss}.py,
  ops/kernels/{preprocess,scan,rasterize,sort,radix}.py (K1-K8),
  train/{config,optimizer,density,loop,checkpoint}.py, golden/ (a copy of
  the float64 oracle), probes/{micro_bench,exp_dma_stream}.py (K9, K10),
  viewer/{headless,server,monitor}.py with viewer/index.html,
  parallel/{mesh,collectives,distributed,train,loop}.py, graft_entry.py,
  and the CLIs render.py, train/__main__.py, bench.py, eval.py,
  verify_gradients.py, bench_scene.py, gaussian_viewer.py, sh_demo.py,
  viewer_fps.py and bench_scaling.py.

This package never imports jax nor easygaussiansplatting_tpu; only the tests
import both. PIL is imported only to decode JPEG on the CPU
(data/image_io.py) and to write the fixtures (data/make_io_fixtures.py).
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
