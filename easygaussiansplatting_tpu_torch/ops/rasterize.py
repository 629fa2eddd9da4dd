"""Render API with a selectable stage-6 backend.

Port of easygaussiansplatting_tpu/ops/rasterize.py (``resolve_backend``,
``raster_from_aux``, ``render``), forward only: the render runs under
``torch.no_grad()``.

Backends:
  "cuda"  — the hand-written kernels: K1 preprocess, K3 cumsums inside
            binning, K4 blend. CUDA tensors only.
  "tiled" — the plain PyTorch versions of all three (ops/stages.py,
            torch.cumsum, ops/rasterize_tiled.py), on any device.
  "auto"  — "cuda" for CUDA tensors, "tiled" for CPU tensors.
"""

import torch

from easygaussiansplatting_tpu_torch.ops import stages
from easygaussiansplatting_tpu_torch.ops.binning import bin_gaussians
from easygaussiansplatting_tpu_torch.ops.kernels.preprocess import fused_preprocess
from easygaussiansplatting_tpu_torch.ops.kernels.rasterize import rasterize_fwd
from easygaussiansplatting_tpu_torch.ops.rasterize_tiled import rasterize_tiled
from easygaussiansplatting_tpu_torch.utils.device import resolve_device

BACKENDS = ("auto", "cuda", "tiled")


def resolve_backend(backend, device):
    """"auto" -> "cuda" on a CUDA device, "tiled" on the CPU; "cuda" on the
    CPU raises."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    device = torch.device(device)
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "tiled"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got device {device}")
    return backend


def raster_from_aux(us, cinv2ds, alphas, colors, depths, areas, valid, *,
                    width, height, backend="auto", max_patches=2**18, max_rows=None,
                    table=None):
    """Stage 6 alone: bin + rasterise already-preprocessed attributes in
    16x16 tiles. The "cuda" backend needs ``table``, the K1 table that
    ``fused_preprocess`` returns.

    Returns (image [3,H,W], aux with contrib, final_tau, n_patches, binning).
    """
    backend = resolve_backend(backend, us.device)
    use_kernels = backend == "cuda"
    if use_kernels and table is None:
        raise ValueError("backend 'cuda' needs the K1 table from fused_preprocess")
    binning = bin_gaussians(
        us, depths, areas, valid, width=width, height=height,
        max_patches=max_patches, max_rows=max_rows,
        # skip-ellipse row culling: candidate set stays pixel-exact vs the
        # AABB while patches drop
        cinv2ds=cinv2ds, alphas=alphas, use_kernels=use_kernels,
    )
    gsid, start, cnt = binning["patch_gsid"], binning["tile_start"], binning["tile_cnt"]
    if use_kernels:
        image, final_tau, contrib = rasterize_fwd(table, gsid, start, cnt,
                                                  width=width, height=height)
    else:
        image, taux = rasterize_tiled(us, cinv2ds, alphas, colors, gsid, start, cnt,
                                      width=width, height=height)
        final_tau, contrib = taux["final_tau"], taux["contrib"]
    return image, {"contrib": contrib, "final_tau": final_tau,
                   "n_patches": binning["total"], "binning": binning}


def _as_param(x, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()


def render(pws, shs, alphas, scales, rots, cam, alive=None, sh_degree=3,
           backend="auto", max_patches=2**18, max_rows=None, device="cuda"):
    """Render one camera. Parameters may be numpy arrays or tensors; they
    are moved to ``device`` as float32 (``shs`` [N, 3*(deg+1)^2], ``alphas``
    [N]). ``device`` defaults to "cuda" and raises when no CUDA device is
    present; pass device="cpu" for the plain path on the CPU.

    Returns (image [3,H,W], aux dict): the preprocess outputs plus contrib,
    final_tau, n_patches and binning.
    """
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    n = len(pws)
    pws, scales, rots = (_as_param(x, dev) for x in (pws, scales, rots))
    shs = _as_param(shs, dev).reshape(n, -1)
    alphas = _as_param(alphas, dev).reshape(n)
    if alive is not None:
        alive = torch.as_tensor(alive, dtype=torch.bool, device=dev)
    with torch.no_grad():
        if backend == "cuda":
            aux = fused_preprocess(pws, shs, alphas, scales, rots, cam, alive=alive,
                                   sh_degree=sh_degree)
            table = aux.pop("table")
        else:
            aux = stages.preprocess(pws, shs, alphas, scales, rots, cam, alive=alive,
                                    sh_degree=sh_degree)
            table = None
        image, raux = raster_from_aux(
            aux["us"], aux["cinv2ds"], aux["alphas"], aux["colors"], aux["depths"],
            aux["areas"], aux["valid"], width=cam.width, height=cam.height,
            backend=backend, max_patches=max_patches, max_rows=max_rows, table=table,
        )
    return image, {**aux, **raux}
