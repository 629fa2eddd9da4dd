"""Tiled rasteriser: vectorised over tiles, chunked over depth.

Port of easygaussiansplatting_tpu/ops/rasterize_tiled.py (``rasterize_tiled``)
and, with ops/blend.py, the plain version of kernel K4
(csrc/rasterize_fwd.cu). :func:`rasterize_tiled_bwd` is the plain version of
kernel K5 (csrc/rasterize_bwd.cu): an explicit reverse replay, not autograd
of the forward. (Autograd through the chunk loop would save several
[T, K_CHUNK, 256] tensors for every chunk of the longest tile list: tens of
GB at the bench size.) Two differences from the JAX tiled rasteriser:

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
from easygaussiansplatting_tpu_torch.ops.blend import blend_chunk_bwd, blend_chunk_fwd

K_CHUNK = 64  # tile-list entries blended per step; any value gives the same result


def _untile(x_tp, gx, gy, tile, height, width):
    """[T, P, ...] -> [H, W, ...]."""
    extra = x_tp.shape[2:]
    x = x_tp.reshape(gy, gx, tile, tile, *extra)
    x = x.transpose(1, 2).reshape(gy * tile, gx * tile, *extra)
    return x[:height, :width]


def _tile(x_hw, gx, gy, tile, fill):
    """[H, W, ...] -> [T, P, ...], pixels past the image set to ``fill``."""
    h, w = x_hw.shape[:2]
    x = torch.full((gy * tile, gx * tile, *x_hw.shape[2:]), fill, dtype=x_hw.dtype,
                   device=x_hw.device)
    x[:h, :w] = x_hw
    x = x.reshape(gy, tile, gx, tile, *x_hw.shape[2:]).transpose(1, 2)
    return x.reshape(gx * gy, tile * tile, *x_hw.shape[2:])


def _geometry(width, height, dev, dtype):
    gx = -(-width // TILE)
    gy = -(-height // TILE)
    t_idx = torch.arange(gx * gy, device=dev)
    origin = torch.stack([(t_idx % gx) * TILE, (t_idx // gx) * TILE], dim=1).to(dtype)
    lin = torch.arange(TILE * TILE, device=dev)
    # tile-local pixel coordinates, row-major within the tile
    return gx, gy, origin, (lin % TILE).to(dtype), (lin // TILE).to(dtype)


def rasterize_tiled(us, cinv2ds, alphas, colors, patch_gsid, tile_start, tile_cnt,
                    *, width, height):
    """Blend binned Gaussians into an image.

    us [N,2], cinv2ds [N,3], alphas [N], colors [N,3]; patch_gsid [M] int32
    (-1 padding), tile_start [T], tile_cnt [T].

    Returns (image [3,H,W], aux: contrib [H,W] int32, final_tau [H,W],
    max_tile_cnt).
    """
    tile, k_chunk = TILE, K_CHUNK
    dev, dtype = us.device, us.dtype
    gx, gy, origin, px, py = _geometry(width, height, dev, dtype)
    n_tiles = gx * gy
    p = tile * tile
    m_total = patch_gsid.shape[0]
    gsid_safe = torch.clamp(patch_gsid, min=0).long()

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


def rasterize_tiled_bwd(us, cinv2ds, alphas, colors, patch_gsid, tile_start, tile_cnt,
                        g_image, final_tau, contrib, *, width, height):
    """Stage-6 backward by reverse replay: walks every tile's list from its
    last chunk to its first, carrying the transmittance (from the forward's
    ``final_tau``) and g . (colour behind) per pixel.

    g_image [3,H,W] is dL/dimage; final_tau [H,W] and contrib [H,W] are the
    forward's. Returns the per-patch gradients [9, M] (d ux, uy, conic a, b,
    c, alpha, r, g, b per patch slot; zero on padding slots and on entries no
    pixel reached).
    """
    k_chunk = K_CHUNK
    dev, dtype = us.device, us.dtype
    gx, gy, origin, px, py = _geometry(width, height, dev, dtype)
    m_total = patch_gsid.shape[0]
    gsid_safe = torch.clamp(patch_gsid, min=0).long()
    g_t = _tile(g_image.permute(1, 2, 0), gx, gy, TILE, 0.0).transpose(1, 2)  # [T,3,P]
    tau = _tile(final_tau, gx, gy, TILE, 1.0)
    cont = _tile(contrib, gx, gy, TILE, 0)
    gag = torch.zeros_like(tau)
    # one scratch row past the patches takes the writes of entries past a tile list
    out = torch.zeros((m_total + 1, 9), dtype=dtype, device=dev)
    max_cnt = int(cont.max()) if cont.numel() else 0  # no entry past it has a gradient
    k_off = torch.arange(k_chunk, device=dev)
    for c in reversed(range(-(-max_cnt // k_chunk))):
        local = c * k_chunk + k_off[None, :]  # [1,K]
        in_list = local < tile_cnt[:, None]
        pidx = torch.clamp(tile_start[:, None].long() + local, 0, max(m_total - 1, 0))
        ok = in_list & (patch_gsid[pidx] >= 0)  # [T,K]
        gid = gsid_safe[pidx]
        grads, tau, gag = blend_chunk_bwd(
            tau, gag, g_t, c * k_chunk, cont, us[gid] - origin[:, None, :], cinv2ds[gid],
            alphas[gid], colors[gid], ok, px, py,
        )
        out[torch.where(in_list, pidx, m_total).reshape(-1)] = grads.reshape(-1, 9)
    return out[:m_total].T.contiguous()
