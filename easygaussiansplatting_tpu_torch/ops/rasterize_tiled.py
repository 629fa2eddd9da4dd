"""Tiled rasteriser: vectorised over tiles, chunked over depth.

Port of easygaussiansplatting_tpu/ops/rasterize_tiled.py (``rasterize_tiled``)
and, with ops/blend.py, the plain version of kernel K4
(csrc/rasterize_fwd.cu). Two differences from the JAX tiled rasteriser:

* it walks every chunk up to the largest ``tile_cnt``, so no tile list is
  truncated (the JAX version stops at ``n_chunks * k_chunk`` entries and
  reports ``n_truncated``);
* the Mahalanobis distance is taken in tile-local coordinates (pixel
  (0..15, 0..15), means shifted by the tile origin), as the Pallas forward
  kernel and the CUDA kernel take it: dx and dy are the same numbers, with
  more mantissa left on the small local values.
"""

import torch

from easygaussiansplatting_tpu_torch.ops.binning import TILE
from easygaussiansplatting_tpu_torch.ops.blend import blend_chunk_fwd

K_CHUNK = 64  # tile-list entries blended per step; any value gives the same result


def _untile(x_tp, gx, gy, tile, height, width):
    """[T, P, ...] -> [H, W, ...]."""
    extra = x_tp.shape[2:]
    x = x_tp.reshape(gy, gx, tile, tile, *extra)
    x = x.transpose(1, 2).reshape(gy * tile, gx * tile, *extra)
    return x[:height, :width]


def rasterize_tiled(us, cinv2ds, alphas, colors, patch_gsid, tile_start, tile_cnt,
                    *, width, height):
    """Blend binned Gaussians into an image.

    us [N,2], cinv2ds [N,3], alphas [N], colors [N,3]; patch_gsid [M] int32
    (-1 padding), tile_start [T], tile_cnt [T].

    Returns (image [3,H,W], aux: contrib [H,W] int32, final_tau [H,W],
    max_tile_cnt).
    """
    tile, k_chunk = TILE, K_CHUNK
    gx = -(-width // tile)
    gy = -(-height // tile)
    n_tiles = gx * gy
    p = tile * tile
    dev, dtype = us.device, us.dtype
    m_total = patch_gsid.shape[0]
    gsid_safe = torch.clamp(patch_gsid, min=0).long()

    t_idx = torch.arange(n_tiles, device=dev)
    origin = torch.stack([(t_idx % gx) * tile, (t_idx // gx) * tile], dim=1).to(dtype)
    lin = torch.arange(p, device=dev)
    px = (lin % tile).to(dtype)  # tile-local, row-major within the tile
    py = (lin // tile).to(dtype)

    max_cnt = int(tile_cnt.max()) if n_tiles else 0
    n_chunks = -(-max_cnt // k_chunk)
    k_off = torch.arange(k_chunk, device=dev)
    tau = torch.ones((n_tiles, p), dtype=dtype, device=dev)
    color = torch.zeros((n_tiles, p, 3), dtype=dtype, device=dev)
    cont = torch.zeros((n_tiles, p), dtype=torch.int32, device=dev)
    for c in range(n_chunks):
        local = c * k_chunk + k_off[None, :]  # [1,K]
        pidx = torch.clamp(tile_start[:, None].long() + local, 0, max(m_total - 1, 0))
        ok = (local < tile_cnt[:, None]) & (patch_gsid[pidx] >= 0)  # [T,K]
        gid = gsid_safe[pidx]
        color_add, tau, cont_local = blend_chunk_fwd(
            tau, us[gid] - origin[:, None, :], cinv2ds[gid], alphas[gid],
            colors[gid], ok, px, py,
        )
        color = color + color_add
        cont = torch.where(cont_local > 0, c * k_chunk + cont_local, cont)

    image = _untile(color, gx, gy, tile, height, width).permute(2, 0, 1)
    aux = {
        "contrib": _untile(cont, gx, gy, tile, height, width),
        "final_tau": _untile(tau, gx, gy, tile, height, width),
        "max_tile_cnt": max_cnt,
    }
    return image.contiguous(), aux
