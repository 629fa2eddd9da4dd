"""Golden model: float64 NumPy implementation of the 6-stage splatting pipeline.

Copy of easygaussiansplatting_tpu/golden/model.py, kept in the port so that
the port's gradient gate (verify_gradients.py) runs where JAX is not
installed: the same functions, names and expressions, with ``sh_basis`` from
the port's utils/sh.py. tests/test_torch_golden.py holds it bit-equal to the
JAX package's copy.

It is the oracle every implementation is validated against. Semantics follow
the reference's tile rasteriser (gsplatcu/kernel.cu, the training contract):

* stage 1 project: pc = Rcw pw + tcw, u = (x fx / z + cx, y fy / z + cy)
  (kernel.cu:553-617); Gaussians with depth < MIN_DEPTH are culled.
* stage 2 cov3d: Sigma = (R S)(R S)^T stored as the 6-element upper triangle
  (kernel.cu:326-423).
* stage 3 cov2d: EWA splatting with x/z, y/z clamped to +-1.3 tan(fov), plus
  0.3 added to the diagonal (kernel.cu:425-551). Note tan_fov = W / (2 fx)
  (gausplat.cu:225-226) -- the *tangent*, unlike the angle used by the
  reference CPU demo (gausplat.py:136, a known reference-internal mismatch).
* stage 4 sh2color: real SH degrees 0..3 along ray dir = normalize(pw - twc),
  color = sum c_lm Y_lm + 0.5 (kernel.cu:619-807).
* stage 5 conic: analytic 2x2 inverse; areas = ceil(3 sqrt(diag))
  (kernel.cu:274-324).
* stage 6 blend: per-tile front-to-back; alpha' = min(0.99,
  alpha exp(-0.5 maha)); entries with alpha' < 0.002 skipped; early stop when
  transmittance tau < 1e-4; records per-pixel contributor count and final tau
  (kernel.cu:152-271).

One deliberate deviation: per-tile draw order is *exact* depth order (stable
on ties) rather than the reference's millimetre-quantised 64-bit sort keys
(kernel.cu:46-80). Within-millimetre ordering differences are below the test
tolerances and the exact order is the better-defined contract.
"""

import numpy as np

from easygaussiansplatting_tpu_torch.utils.sh import sh_basis

MIN_DEPTH = 0.2
TILE = 16  # pixels per tile edge (reference BLOCK, common.cuh:13)
ALPHA_CLAMP = 0.99
ALPHA_SKIP = 0.002
TAU_STOP = 1e-4


def project(pws, Rcw, tcw, fx, fy, cx, cy):
    """Stage 1. Returns (us [N,2], pcs [N,3], depths [N])."""
    pcs = pws @ np.asarray(Rcw).T + np.asarray(tcw)
    z = pcs[:, 2]
    us = np.stack([pcs[:, 0] * fx / z + cx, pcs[:, 1] * fy / z + cy], axis=1)
    return us, pcs, z.copy()


def compute_cov3d(rots, scales):
    """Stage 2. rots are unit wxyz quaternions. Returns [N,6] upper triangle
    (xx, xy, xz, yy, yz, zz)."""
    w, x, y, z = rots[:, 0], rots[:, 1], rots[:, 2], rots[:, 3]
    R = np.empty((rots.shape[0], 3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - z * w)
    R[:, 0, 2] = 2 * (x * z + y * w)
    R[:, 1, 0] = 2 * (x * y + z * w)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - x * w)
    R[:, 2, 0] = 2 * (x * z - y * w)
    R[:, 2, 1] = 2 * (y * z + x * w)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    M = R * scales[:, None, :]  # R @ diag(s)
    Sigma = M @ M.transpose(0, 2, 1)
    iu = np.triu_indices(3)
    return Sigma[:, iu[0], iu[1]]


def compute_cov2d(cov3ds, pcs, Rcw, fx, fy, width, height):
    """Stage 3 (EWA). Returns [N,3] = (a, b, c) of [[a,b],[b,c]]."""
    x, y, z = pcs[:, 0], pcs[:, 1], pcs[:, 2]
    tan_fovx = width / (2.0 * fx)
    tan_fovy = height / (2.0 * fy)
    x = np.clip(x / z, -1.3 * tan_fovx, 1.3 * tan_fovx) * z
    y = np.clip(y / z, -1.3 * tan_fovy, 1.3 * tan_fovy) * z
    J = np.zeros((pcs.shape[0], 2, 3))
    J[:, 0, 0] = fx / z
    J[:, 0, 2] = -fx * x / (z * z)
    J[:, 1, 1] = fy / z
    J[:, 1, 2] = -fy * y / (z * z)
    M = J @ np.asarray(Rcw)[None]
    iu = np.triu_indices(3)
    Sigma = np.zeros((cov3ds.shape[0], 3, 3))
    Sigma[:, iu[0], iu[1]] = cov3ds
    Sigma[:, iu[1], iu[0]] = cov3ds
    Sp = M @ Sigma @ M.transpose(0, 2, 1)
    return np.stack([Sp[:, 0, 0] + 0.3, Sp[:, 0, 1], Sp[:, 1, 1] + 0.3], axis=1)


def sh2color(shs, pws, twc, degree=None):
    """Stage 4. shs: [N, 3*(deg+1)^2] interleaved RGB per basis fn."""
    n_bases = shs.shape[1] // 3
    if degree is None:
        degree = int(np.sqrt(n_bases)) - 1
    ray = pws - np.asarray(twc)
    ray = ray / np.linalg.norm(ray, axis=1, keepdims=True)
    basis = sh_basis(np, ray[:, 0], ray[:, 1], ray[:, 2], degree)
    color = np.full((pws.shape[0], 3), 0.5)
    for k, b in enumerate(basis[:n_bases]):
        color = color + b[:, None] * shs[:, 3 * k : 3 * k + 3]
    return color


def inverse_cov2d(cov2ds):
    """Stage 5. Returns (cinv [N,3], areas [N,2] int32 3-sigma half-extents)."""
    a, b, c = cov2ds[:, 0], cov2ds[:, 1], cov2ds[:, 2]
    det = a * c - b * b
    with np.errstate(divide="ignore", invalid="ignore"):
        det_inv = 1.0 / det
    cinv = np.stack([c * det_inv, -b * det_inv, a * det_inv], axis=1)
    areas = np.stack(
        [np.ceil(3.0 * np.sqrt(np.abs(a))), np.ceil(3.0 * np.sqrt(np.abs(c)))], axis=1
    ).astype(np.int32)
    return cinv, areas


def gaussian_rects(us, areas, depths, width, height, tile=TILE):
    """Per-Gaussian tile-space rectangles [x0, y0, x1, y1) and validity.

    Matches getRects (the reference's gsplatcu/kernel.cu:82-122): clamp to the
    tile grid; empty rectangles invalidate the Gaussian.
    """
    gx = (width + tile - 1) // tile
    gy = (height + tile - 1) // tile
    x0 = np.clip(np.floor((us[:, 0] - areas[:, 0]) / tile), 0, gx).astype(np.int64)
    y0 = np.clip(np.floor((us[:, 1] - areas[:, 1]) / tile), 0, gy).astype(np.int64)
    x1 = np.clip(np.ceil((us[:, 0] + areas[:, 0]) / tile), 0, gx).astype(np.int64)
    y1 = np.clip(np.ceil((us[:, 1] + areas[:, 1]) / tile), 0, gy).astype(np.int64)
    valid = (depths >= MIN_DEPTH) & ((x1 - x0) * (y1 - y0) > 0)
    return np.stack([x0, y0, x1, y1], axis=1), valid


def tile_lists(us, areas, depths, width, height, tile=TILE):
    """Per-tile draw lists: dict tile_id -> depth-ordered gaussian index array."""
    rects, valid = gaussian_rects(us, areas, depths, width, height, tile)
    gx = (width + tile - 1) // tile
    gy = (height + tile - 1) // tile
    order = np.argsort(depths, kind="stable")
    lists = {t: [] for t in range(gx * gy)}
    for i in order:
        if not valid[i]:
            continue
        x0, y0, x1, y1 = rects[i]
        for ty in range(y0, y1):
            for tx in range(x0, x1):
                lists[ty * gx + tx].append(i)
    return {t: np.asarray(v, dtype=np.int64) for t, v in lists.items()}, (gx, gy)


def render_tiles(us, cinv2ds, alphas, depths, colors, areas, width, height, tile=TILE):
    """Stage 6: per-pixel front-to-back alpha blending over tile lists.

    Returns (image [3,H,W], contrib [H,W] int32, final_tau [H,W]).
    """
    lists, (gx, gy) = tile_lists(us, areas, depths, width, height, tile)
    image = np.zeros((3, height, width))
    contrib = np.zeros((height, width), dtype=np.int32)
    final_tau = np.ones((height, width))

    for t, gids in lists.items():
        if len(gids) == 0:
            continue
        ty, tx = divmod(t, gx)
        for py in range(ty * tile, min((ty + 1) * tile, height)):
            for px in range(tx * tile, min((tx + 1) * tile, width)):
                tau = 1.0
                color = np.zeros(3)
                cont = 0
                for n, i in enumerate(gids):
                    dx = us[i, 0] - px
                    dy = us[i, 1] - py
                    maha = max(
                        0.0,
                        cinv2ds[i, 0] * dx * dx
                        + cinv2ds[i, 2] * dy * dy
                        + 2.0 * cinv2ds[i, 1] * dx * dy,
                    )
                    alpha_prime = min(ALPHA_CLAMP, alphas[i] * np.exp(-0.5 * maha))
                    if alpha_prime < ALPHA_SKIP:
                        continue
                    color += tau * alpha_prime * colors[i]
                    cont = n + 1
                    tau *= 1.0 - alpha_prime
                    if tau < TAU_STOP:
                        break
                image[:, py, px] = color
                contrib[py, px] = cont
                final_tau[py, px] = tau
    return image, contrib, final_tau


def render(pws, shs, alphas, scales, rots, Rcw, tcw, fx, fy, cx, cy, width, height):
    """Full 6-stage forward. Returns (image [3,H,W], aux dict of stage outputs)."""
    us, pcs, depths = project(pws, Rcw, tcw, fx, fy, cx, cy)
    cov3ds = compute_cov3d(rots, scales)
    cov2ds = compute_cov2d(cov3ds, pcs, np.asarray(Rcw), fx, fy, width, height)
    twc = -np.asarray(Rcw).T @ np.asarray(tcw)
    colors = sh2color(shs, pws, twc)
    cinv2ds, areas = inverse_cov2d(cov2ds)
    image, contrib, final_tau = render_tiles(
        us, cinv2ds, alphas, depths, colors, areas, width, height
    )
    aux = {
        "us": us,
        "pcs": pcs,
        "depths": depths,
        "cov3ds": cov3ds,
        "cov2ds": cov2ds,
        "colors": colors,
        "cinv2ds": cinv2ds,
        "areas": areas,
        "contrib": contrib,
        "final_tau": final_tau,
    }
    return image, aux
