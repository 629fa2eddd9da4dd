"""Plain PyTorch reference of the render: preprocess, tile binning and the
alpha blend, forward and (through autograd) backward.

Written from the method's published description (Kerbl et al. 2023,
*3D Gaussian Splatting*; the reference CUDA rasteriser's draw rules), not
from the program, and imports nothing of it:

* project with the pinhole camera; EWA 2D covariance ``J W S J^T + 0.3 I``
  with x/z and y/z clamped to 1.3 tan(fov/2); conic = its inverse; the
  3-sigma extent ``ceil(3 sqrt(diag))``; colour = real SH of degree 3
  along the ray from the camera centre, + 0.5; entries with depth < 0.2 are
  culled;
* a gaussian is considered for a pixel iff its 3-sigma rectangle covers the
  pixel's 16x16 tile; pixel centres lie on integer coordinates;
* alpha' = min(0.99, alpha exp(-maha / 2)); entries with alpha' < 0.002 are
  skipped; an entry contributes while the transmittance in front of it is
  at least 1e-4; the background is black.

The blend runs over blocks of tiles, each padded to its longest tile list,
so it fits in memory at full frame size. :func:`render_grad` renders with
gradients by recomputing each block under autograd against the image's
cotangent. Everything is computed in ``dtype`` (float32 for the reference,
bfloat16 for the precision control).
"""

import math

import numpy as np
import torch

TILE = 16
ALPHA_CLAMP = 0.99
ALPHA_SKIP = 0.002
TAU_STOP = 1e-4
MIN_DEPTH = 0.2
BLOCK_ELEMS = 2**24  # (tile, entry, pixel) elements of one blend block

_C1 = math.sqrt(3.0 / (4.0 * math.pi))
_C2 = (0.5 * math.sqrt(15.0 / math.pi), -0.5 * math.sqrt(15.0 / math.pi),
       0.25 * math.sqrt(5.0 / math.pi), -0.5 * math.sqrt(15.0 / math.pi),
       0.25 * math.sqrt(15.0 / math.pi))
_C3 = (-0.25 * math.sqrt(35.0 / (2.0 * math.pi)), 0.5 * math.sqrt(105.0 / math.pi),
       -0.25 * math.sqrt(21.0 / (2.0 * math.pi)), 0.25 * math.sqrt(7.0 / math.pi),
       -0.25 * math.sqrt(21.0 / (2.0 * math.pi)), 0.25 * math.sqrt(105.0 / math.pi),
       -0.25 * math.sqrt(35.0 / (2.0 * math.pi)))
SH_C0 = 0.5 * math.sqrt(1.0 / math.pi)


def sh_basis(x, y, z):
    """The 16 real SH basis functions of degrees 0..3 at unit (x, y, z), in
    the order of the coefficient columns (m = -l..l within each degree)."""
    xx, yy, zz = x * x, y * y, z * z
    return [SH_C0 * torch.ones_like(x), -_C1 * y, _C1 * z, -_C1 * x,
            _C2[0] * x * y, _C2[1] * y * z, _C2[2] * (2 * zz - xx - yy), _C2[3] * x * z,
            _C2[4] * (xx - yy),
            _C3[0] * y * (3 * xx - yy), _C3[1] * x * y * z, _C3[2] * y * (4 * zz - xx - yy),
            _C3[3] * z * (2 * zz - 3 * xx - 3 * yy), _C3[4] * x * (4 * zz - xx - yy),
            _C3[5] * z * (xx - yy), _C3[6] * x * (xx - 3 * yy)]


def camera_tensors(cam, device, dtype):
    r = torch.as_tensor(np.asarray(cam["Rcw"], np.float64), dtype=dtype, device=device)
    t = torch.as_tensor(np.asarray(cam["tcw"], np.float64), dtype=dtype, device=device)
    return r, t


def preprocess(pws, shs, alphas, scales, rots, cam, alive=None):
    """Per-gaussian screen quantities: dict of us [N,2], conic [N,3] (a, b,
    c of the inverse 2D covariance), color [N,3], alpha [N], depth [N],
    extent [N,2] (3-sigma half sizes in pixels) and valid [N]. ``shs`` is
    [N, 3 * bases] with RGB interleaved per basis function; ``rots`` are
    unit wxyz quaternions."""
    dtype, dev = pws.dtype, pws.device
    r, t = camera_tensors(cam, dev, dtype)
    fx, fy = float(cam["fx"]), float(cam["fy"])
    cx, cy = float(cam["cx"]), float(cam["cy"])
    pc = pws @ r.T + t
    z = pc[:, 2]
    zs = torch.where(z >= MIN_DEPTH, z, torch.ones_like(z))
    us = torch.stack([pc[:, 0] * fx / zs + cx, pc[:, 1] * fy / zs + cy], dim=1)

    w, x, y, zq = rots.unbind(1)
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + zq * zq), 2 * (x * y - zq * w), 2 * (x * zq + y * w)], -1),
        torch.stack([2 * (x * y + zq * w), 1 - 2 * (x * x + zq * zq), 2 * (y * zq - x * w)], -1),
        torch.stack([2 * (x * zq - y * w), 2 * (y * zq + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], dim=1)  # [N,3,3]
    m = rot * scales[:, None, :]
    sigma = m @ m.transpose(1, 2)

    limx = 1.3 * cam["width"] / (2.0 * fx)
    limy = 1.3 * cam["height"] / (2.0 * fy)
    tx = torch.clamp(pc[:, 0] / zs, -limx, limx) * zs
    ty = torch.clamp(pc[:, 1] / zs, -limy, limy) * zs
    zero = torch.zeros_like(zs)
    jac = torch.stack([torch.stack([fx / zs, zero, -fx * tx / (zs * zs)], -1),
                       torch.stack([zero, fy / zs, -fy * ty / (zs * zs)], -1)], dim=1)
    jw = jac @ r  # [N,2,3]
    cov = jw @ sigma @ jw.transpose(1, 2)
    a = cov[:, 0, 0] + 0.3
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + 0.3
    det = a * c - b * b
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    conic = torch.stack([c / det, -b / det, a / det], dim=1)
    extent = torch.ceil(3.0 * torch.sqrt(torch.stack([a, c], dim=1).abs()))

    twc = -r.T @ t
    d = pws - twc
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True), min=1e-12)
    basis = sh_basis(d[:, 0], d[:, 1], d[:, 2])
    coef = shs.reshape(len(shs), -1, 3)
    color = 0.5 + sum(basis[k][:, None] * coef[:, k] for k in range(coef.shape[1]))

    valid = (z >= MIN_DEPTH) & (alphas >= ALPHA_SKIP)
    if alive is not None:
        valid = valid & alive
    return {"us": us, "conic": conic, "color": color, "alpha": alphas, "depth": z,
            "extent": extent, "valid": valid}


def tile_lists(us, extent, depth, valid, width, height):
    """Each tile's gaussians in depth order: (gid [M] int64, count [T],
    start [T]); a gaussian is listed in every tile its 3-sigma rectangle
    covers, depth ties broken by index."""
    gx, gy = -(-width // TILE), -(-height // TILE)
    us, extent = us.detach().float(), extent.detach().float()
    x0 = torch.clamp(torch.floor((us[:, 0] - extent[:, 0]) / TILE), 0, gx).long()
    y0 = torch.clamp(torch.floor((us[:, 1] - extent[:, 1]) / TILE), 0, gy).long()
    x1 = torch.clamp(torch.ceil((us[:, 0] + extent[:, 0]) / TILE), 0, gx).long()
    y1 = torch.clamp(torch.ceil((us[:, 1] + extent[:, 1]) / TILE), 0, gy).long()
    n = torch.where(valid, (x1 - x0) * (y1 - y0), 0).clamp(min=0)
    order = torch.sort(torch.where(n > 0, depth.detach().float(), torch.inf), stable=True).indices
    order = order[n[order] > 0]
    cnt = n[order]
    gid = torch.repeat_interleave(order, cnt)
    first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    k = torch.arange(len(gid), device=gid.device) - first
    w = (x1 - x0)[gid]
    tile = (y0[gid] + k // w) * gx + x0[gid] + k % w
    tile, perm = torch.sort(tile, stable=True)
    gid = gid[perm]
    count = torch.bincount(tile, minlength=gx * gy)
    return gid, count, torch.cumsum(count, 0) - count


def blend_blocks(count):
    """Tile blocks for the blend: lists of tile ids, tiles of similar list
    length together, each block within BLOCK_ELEMS padded elements."""
    order = torch.sort(count, descending=True, stable=True).indices.tolist()
    cnt = count.tolist()
    blocks, cur, kmax = [], [], 0
    for t in order:
        if cnt[t] == 0:
            break
        k = max(kmax, cnt[t])
        if cur and (len(cur) + 1) * k * TILE * TILE > BLOCK_ELEMS:
            blocks.append(cur)
            cur, k = [], cnt[t]
        cur.append(t)
        kmax = k
    if cur:
        blocks.append(cur)
    return blocks


def blend_block(pre, gid, count, start, tiles, width):
    """Blend the tiles ``tiles`` (list of ids): [B, 3, 256] colours."""
    dev = gid.device
    gx = -(-width // TILE)
    t = torch.tensor(tiles, device=dev)
    kmax = int(count[t].max())
    k = torch.arange(kmax, device=dev)
    ok = k[None, :] < count[t][:, None]
    idx = torch.where(ok, start[t][:, None] + k[None, :], 0)
    g = gid[idx]  # [B, K]
    dtype = pre["us"].dtype
    origin = torch.stack([(t % gx) * TILE, (t // gx) * TILE], dim=1).to(dtype)
    lin = torch.arange(TILE * TILE, device=dev)
    px, py = (lin % TILE).to(dtype), (lin // TILE).to(dtype)
    u = pre["us"][g] - origin[:, None, :]
    cn = pre["conic"][g]
    dx = u[..., 0:1] - px
    dy = u[..., 1:2] - py
    maha = cn[..., 0:1] * dx * dx + cn[..., 2:3] * dy * dy + 2.0 * cn[..., 1:2] * dx * dy
    ap = pre["alpha"][g][..., None] * torch.exp(-0.5 * torch.clamp(maha, min=0.0))
    ap = torch.where(ok[..., None], torch.clamp(ap, max=ALPHA_CLAMP), torch.zeros_like(ap))
    live = ap >= ALPHA_SKIP
    trans = torch.cumprod(torch.where(live, 1.0 - ap, torch.ones_like(ap)), dim=1)
    front = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
    wgt = torch.where(live & (front >= TAU_STOP), front * ap, torch.zeros_like(ap))
    return (wgt[:, :, None, :] * pre["color"][g][..., None]).sum(1)  # [B, 3, P]


def _place(out, block, tiles, width):
    gx = -(-width // TILE)
    for j, t in enumerate(tiles):
        ty, tx = divmod(t, gx)
        out[:, ty * TILE:(ty + 1) * TILE, tx * TILE:(tx + 1) * TILE] = \
            block[j].reshape(3, TILE, TILE)


def _padded(width, height, dtype, device):
    gx, gy = -(-width // TILE), -(-height // TILE)
    return torch.zeros((3, gy * TILE, gx * TILE), dtype=dtype, device=device)


def rasterize(pre, width, height):
    """The image [3, H, W] of preprocessed gaussians, without gradients."""
    gid, count, start = tile_lists(pre["us"], pre["extent"], pre["depth"], pre["valid"],
                                   width, height)
    out = _padded(width, height, pre["us"].dtype, pre["us"].device)
    with torch.no_grad():
        for tiles in blend_blocks(count):
            _place(out, blend_block(pre, gid, count, start, tiles, width), tiles, width)
    return out[:, :height, :width]


def render(params, cam, alive=None):
    """Forward render of activated ``params`` (pws, shs, alphas, scales,
    rots) from ``cam``: the image [3, H, W]."""
    with torch.no_grad():
        pre = preprocess(*(params[k] for k in ("pws", "shs", "alphas", "scales", "rots")), cam,
                         alive)
        return rasterize(pre, cam["width"], cam["height"])


def render_grad(params, cam, image_loss, alive=None):
    """Render ``params`` (tensors that require grad) from ``cam``, evaluate
    ``image_loss(image) -> 0-d loss`` and accumulate the loss's gradients
    into the params' ``.grad``. The blend is run twice: once without
    gradients for the image, then block by block under autograd against the
    image's cotangent. Returns (loss, image), detached."""
    w, h = cam["width"], cam["height"]
    pre = preprocess(*(params[k] for k in ("pws", "shs", "alphas", "scales", "rots")), cam,
                     alive)
    keys = ("us", "conic", "color", "alpha")
    leaves = {k: pre[k].detach().requires_grad_(True) for k in keys}
    leaf_pre = {**pre, **leaves}
    image = rasterize({k: v.detach() if torch.is_tensor(v) else v for k, v in leaf_pre.items()},
                      w, h).clone().requires_grad_(True)
    loss = image_loss(image)
    (g_image,) = torch.autograd.grad(loss, image)
    g_pad = _padded(w, h, g_image.dtype, g_image.device)
    g_pad[:, :h, :w] = g_image
    gid, count, start = tile_lists(pre["us"], pre["extent"], pre["depth"], pre["valid"], w, h)
    gx = -(-w // TILE)
    for tiles in blend_blocks(count):
        block = blend_block(leaf_pre, gid, count, start, tiles, w)
        t = torch.tensor(tiles, device=block.device)
        ty, tx = t // gx, t % gx
        rows = (ty[:, None] * TILE + torch.arange(TILE, device=t.device))[:, :, None]
        cols = (tx[:, None] * TILE + torch.arange(TILE, device=t.device))[:, None, :]
        g_block = g_pad[:, rows, cols].permute(1, 0, 2, 3).reshape(block.shape)
        block.backward(g_block)
    torch.autograd.backward([pre[k] for k in keys], [leaves[k].grad if leaves[k].grad is not None
                                                     else torch.zeros_like(leaves[k])
                                                     for k in keys])
    return loss.detach(), image.detach()
