"""Render API with a selectable stage-6 backend, differentiable.

Port of easygaussiansplatting_tpu/ops/rasterize.py (``resolve_backend``,
``raster_from_aux``, ``render``).

Backends:
  "cuda"  — the hand-written kernels: K1 preprocess, K12 binning (with
            K3 cumsums), K4 blend, and for gradients K2, K5 and K6. CUDA
            tensors only.
  "tiled" — the plain PyTorch versions of all of them (ops/stages.py,
            torch.cumsum, ops/rasterize_tiled.py, the autograd VJP of the
            stages), on any device.
  "dense" — the O(N*H*W) reference rasteriser of ops/rasterize_ref.py
            after the plain stages, plain autograd, on any device: for
            tests and tiny scenes only.
  "auto"  — "cuda" for CUDA tensors, "tiled" for CPU tensors.

"cuda" and "tiled" run the same two ``autograd.Function``s,
:class:`PreprocessFunction` and :class:`RasterizeFunction`, with the kernels
or their plain versions inside. With ``need_grads=True`` (the default, as in
JAX) the render builds the autograd graph, and binning also returns the
per-gaussian patch counts the backward's gradient reduce reads;
``need_grads=False`` renders under ``torch.no_grad()``. Binning's inputs
are detached, as the JAX ones are ``stop_gradient``: its integer outputs
take no gradient.

With tracing on (utils/trace.py) the stages are the spans
``render.preprocess``, ``render.binning`` and ``render.blend``, and
binning's patch and row counts and its route (``binning.kernel``: 1 for
K12, 0 for the slot path) the request's ``binning.*`` counters; K4's work
items walked and left, and its pixels walked again over a chunk, its
``blend.*`` counters (ops/kernels/rasterize.py ``COUNTERS``).
"""

import torch

from easygaussiansplatting_tpu_torch.ops import stages
from easygaussiansplatting_tpu_torch.ops.binning import bin_gaussians
from easygaussiansplatting_tpu_torch.ops.kernels.preprocess import (
    PreprocessFunction,
    offset_table,
    pack_table,
    table_views,
)
from easygaussiansplatting_tpu_torch.ops.kernels.rasterize import RasterizeFunction
from easygaussiansplatting_tpu_torch.utils import trace
from easygaussiansplatting_tpu_torch.utils.device import resolve_device

BACKENDS = ("auto", "cuda", "tiled", "dense")


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
                    need_grads=True, table=None):
    """Stage 6 alone: bin + rasterise already-preprocessed attributes in
    16x16 tiles. The "cuda" backend needs ``table``, the K1 table that
    ``fused_preprocess`` or :class:`PreprocessFunction` returns; the "tiled"
    backend packs one from the attributes when none is given. With
    ``need_grads`` the image's gradient flows into the table.

    Returns (image [3,H,W], aux with contrib, final_tau, n_patches, binning;
    the "dense" backend bins nothing and gives contrib and final_tau only).
    """
    backend = resolve_backend(backend, us.device)
    if backend == "dense":
        from easygaussiansplatting_tpu_torch.ops.rasterize_ref import rasterize_dense

        with torch.set_grad_enabled(need_grads and torch.is_grad_enabled()):
            image, contrib, final_tau = rasterize_dense(
                us, cinv2ds, alphas, colors, depths, areas, valid, width=width, height=height)
        return image, {"contrib": contrib, "final_tau": final_tau}
    use_kernels = backend == "cuda"
    if table is None:
        if use_kernels:
            raise ValueError("backend 'cuda' needs the K1 table from fused_preprocess")
        table = pack_table(us, cinv2ds, alphas, colors, depths, areas)
    with trace.span("render.binning"):
        binning = bin_gaussians(
            us.detach(), depths.detach(), areas.detach(), valid, width=width, height=height,
            max_patches=max_patches, max_rows=max_rows,
            # skip-ellipse row culling: candidate set stays pixel-exact vs the
            # AABB while patches drop
            cinv2ds=cinv2ds.detach(), alphas=alphas.detach(), gsid_counts=need_grads,
            use_kernels=use_kernels,
        )
    # the request's counters (tracing on): patches needed and dropped, the
    # slots of the budget, and whether K12 (1) or the slot path (0) binned
    trace.count({"binning.patches": binning["total"], "binning.dropped": binning["n_dropped"],
                 "binning.rows": binning["total_rows"],
                 "binning.rows_dropped": binning["rows_dropped"], "binning.slots": max_patches,
                 "binning.kernel": int(binning["kernel"])})
    counters = {} if trace.counting() else None
    with torch.set_grad_enabled(need_grads and torch.is_grad_enabled()), \
            trace.span("render.blend"):
        image, final_tau, contrib = RasterizeFunction.apply(
            table, binning["patch_gsid"], binning["tile_start"], binning["tile_cnt"],
            binning.get("gsid_counts"), width, height, use_kernels, counters)
    if counters:
        trace.count(counters)
    return image, {"contrib": contrib, "final_tau": final_tau,
                   "n_patches": binning["total"], "binning": binning}


def _as_param(x, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()


def render(pws, shs, alphas, scales, rots, cam, alive=None, us_offset=None, sh_degree=3,
           backend="auto", max_patches=2**18, max_rows=None, need_grads=True,
           device="cuda"):
    """Render one camera. Parameters may be numpy arrays or tensors; they
    are moved to ``device`` as float32 (``shs`` [N, 3*(deg+1)^2], ``alphas``
    [N]); tensors already there keep their autograd history. ``device``
    defaults to "cuda" and raises when no CUDA device is present; pass
    device="cpu" for the plain path on the CPU.

    ``us_offset`` [N, 2] (zeros) is added to the projected screen positions,
    so the gradient of the loss with respect to it is the per-gaussian
    screen-space gradient densification reads.

    Returns (image [3,H,W], aux dict): the preprocess outputs (us, cinv2ds,
    colors, alphas, depths, areas, valid) plus contrib, final_tau, n_patches
    and binning. The "dense" backend runs ops/stages.py's ``preprocess`` and
    gives all of its outputs, contrib and final_tau.
    """
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    n = len(pws)
    pws, scales, rots = (_as_param(x, dev) for x in (pws, scales, rots))
    shs = _as_param(shs, dev).reshape(n, -1)
    alphas = _as_param(alphas, dev).reshape(n)
    if alive is not None:
        alive = torch.as_tensor(alive, dtype=torch.bool, device=dev)
    if backend == "dense":  # the plain stages, as JAX's render runs them for it
        with torch.set_grad_enabled(need_grads and torch.is_grad_enabled()):
            aux = stages.preprocess(pws, shs, alphas, scales, rots, cam, alive=alive,
                                    sh_degree=sh_degree)
            if us_offset is not None:
                aux["us"] = aux["us"] + us_offset
            image, raux = raster_from_aux(
                *(aux[k] for k in ("us", "cinv2ds", "alphas", "colors", "depths", "areas",
                                   "valid")),
                width=cam.width, height=cam.height, backend=backend, need_grads=need_grads)
        return image, {**aux, **raux}
    with torch.set_grad_enabled(need_grads and torch.is_grad_enabled()):
        with trace.span("render.preprocess"):
            table = PreprocessFunction.apply(pws, shs, alphas, scales, rots, cam, sh_degree,
                                             backend == "cuda")
            table, _ = offset_table(table, us_offset)
            aux = table_views(table, alphas, alive)
        image, raux = raster_from_aux(
            *(aux[k] for k in ("us", "cinv2ds", "alphas", "colors", "depths", "areas", "valid")),
            width=cam.width, height=cam.height, backend=backend, max_patches=max_patches,
            max_rows=max_rows, need_grads=need_grads, table=table)
    return image, {**aux, **raux}
