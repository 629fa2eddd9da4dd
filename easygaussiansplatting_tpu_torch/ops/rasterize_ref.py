"""Reference rasteriser: plain PyTorch, exact semantics, differentiable.

Port of easygaussiansplatting_tpu/ops/rasterize_ref.py. A loop over the
depth-sorted gaussians carrying per-pixel transmittance -- O(N * H * W),
for correctness (tests, tiny scenes, golden cross-checks), not speed: the
render path is ops/rasterize.py's "cuda" and "tiled" backends. Both
implement the reference draw kernel's contract:

* tile coverage: a gaussian is considered for a pixel iff its 3-sigma rect
  covers the pixel's 16x16 tile (not the pixel itself);
* alpha' = min(0.99, alpha * exp(-0.5 * max(0, maha)));
* entries with alpha' < 0.002 are skipped entirely;
* an entry contributes iff running tau >= 1e-4 (early-termination rule);
* contrib = 1-based index (within the pixel's tile list) of the last
  contributing entry; final_tau = tau after the last contribution.

Gradients come from autograd through the loop, as JAX's come from AD
through its ``lax.scan``: ``torch.minimum`` gives the alpha'-saturated
splat (alpha' = 0.99) a zero subgradient, as ``jnp.minimum`` does, and
halves a tie as it does.
"""

import torch

from easygaussiansplatting_tpu_torch.ops import stages
from easygaussiansplatting_tpu_torch.ops.binning import gaussian_rects

ALPHA_CLAMP = 0.99
ALPHA_SKIP = 0.002
TAU_STOP = 1e-4


def rasterize_dense(us, cinv2ds, alphas, colors, depths, areas, valid, *, width, height,
                    tile=16):
    """Blend all gaussians into an image by walking them in depth order.

    Returns (image [3,H,W], contrib [H,W] int32, final_tau [H,W])."""
    dev, dtype = us.device, us.dtype
    inf = torch.tensor(float("inf"), dtype=depths.dtype, device=dev)
    order = torch.argsort(torch.where(valid, depths, inf), stable=True)
    rects, valid = gaussian_rects(us, areas, valid, width, height, tile)

    px = torch.arange(width, dtype=dtype, device=dev)[None, :]
    py = torch.arange(height, dtype=dtype, device=dev)[:, None]
    tpx = (torch.arange(width, dtype=torch.int32, device=dev) // tile)[None, :]
    tpy = (torch.arange(height, dtype=torch.int32, device=dev) // tile)[:, None]

    zero = torch.zeros((), dtype=dtype, device=dev)
    clamp = torch.tensor(ALPHA_CLAMP, dtype=dtype, device=dev)
    tau = torch.ones((height, width), dtype=dtype, device=dev)
    color = torch.zeros((3, height, width), dtype=dtype, device=dev)
    cont = torch.zeros((height, width), dtype=torch.int32, device=dev)
    cont_tmp = cont
    for g in order.tolist():
        rect = rects[g]
        covered = (valid[g] & (tpx >= rect[0]) & (tpx < rect[2])
                   & (tpy >= rect[1]) & (tpy < rect[3]))
        u, cinv = us[g], cinv2ds[g]
        dx = u[0] - px
        dy = u[1] - py
        # torch.maximum / minimum split a tie's gradient as jnp's do
        maha = torch.maximum(zero, cinv[0] * dx * dx + cinv[2] * dy * dy
                             + 2.0 * cinv[1] * dx * dy)
        alpha_prime = torch.minimum(clamp, alphas[g] * torch.exp(-0.5 * maha))
        live = tau >= TAU_STOP
        cont_tmp = cont_tmp + (covered & live).to(torch.int32)
        m = covered & (alpha_prime >= ALPHA_SKIP) & live
        w = torch.where(m, tau * alpha_prime, zero)
        color = color + w[None] * colors[g][:, None, None]
        tau = torch.where(m, tau * (1.0 - alpha_prime), tau)
        cont = torch.where(m, cont_tmp, cont)
    return color, cont, tau


def render_reference(pws, shs, alphas, scales, rots, cam, alive=None, sh_degree=3, tile=16):
    """Full differentiable forward with the reference rasteriser: stages
    1-5 (ops/stages.py) and :func:`rasterize_dense`. Returns (image
    [3,H,W], the preprocess outputs with contrib and final_tau)."""
    aux = stages.preprocess(pws, shs, alphas, scales, rots, cam, alive=alive,
                            sh_degree=sh_degree)
    image, contrib, final_tau = rasterize_dense(
        aux["us"], aux["cinv2ds"], aux["alphas"], aux["colors"], aux["depths"],
        aux["areas"], aux["valid"], width=cam.width, height=cam.height, tile=tile,
    )
    return image, {**aux, "contrib": contrib, "final_tau": final_tau}
