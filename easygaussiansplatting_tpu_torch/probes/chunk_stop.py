"""The stop inside a chunk: the plain stage-6 forward against K4 and K5 on
tiles built so that many pixels fall below the 1e-4 transmittance stop a
few ulps from it, inside the first chunk of their list.

Run as

    python -m easygaussiansplatting_tpu_torch.probes.chunk_stop [--device cpu] [--tiles N]

The plain forward (ops/rasterize_tiled.py) blends a tile's list in chunks of
K_CHUNK entries. Inside a chunk it decides the stop from cumulative products
(``tau_ex``); it leaves the chunk with an exit transmittance. Two exits are
compared here:

* ``product``: ``tau_in * prod(1 - alpha')`` over the chunk's contributors,
  the shape that ops/blend.py::blend_chunk_fwd had before, and that the JAX
  package's ``blend_chunk_fwd`` (``jnp.prod``) and Pallas forward kernel (a
  halving tree) still have. Where the product rounds apart from the
  cumulative one, a pixel that stopped can leave the chunk at or above
  1e-4, and the next chunk starts it again;
* ``stop``: ops/blend.py::blend_chunk_fwd as it is, which leaves with the
  first excluded ``tau_ex`` where the stop fell inside the chunk.

Each of ``--tiles`` 16x16 tiles (1,024 x 512 pixels at the default 2,048)
holds 2 * K_CHUNK entries, drawn from ``default_rng(0)``: entry 0 covers
the tile with a tiny conic, so that its alpha' (and so each pixel's
transmittance) differs from pixel to pixel by a few ulps; entries 1 to
K_CHUNK - 1 have a zero conic (alpha' = alpha at every pixel) and put the
stop near a position drawn in the first chunk; the second chunk's entries
(alpha 0.5) take any pixel that comes out of the first chunk at or above
1e-4. K4 and K5 stop each pixel for good; so does the ``stop`` exit.

It prints, for each exit: the pixels the second chunk takes again
(``resumed``), the pixels whose contrib differs from K4's, and the
gradients of one backward (plain backward on the plain forward's outputs,
against K5 on K4's) as the largest error over each of the nine rows
relative to that row's max|want|, the measure of chip_smoke.py's step
check. The last line is one JSON object with those numbers and the card's
name and power limit. It exits non-zero when the ``stop`` exit resumes a
pixel. On the CPU the kernels' wrappers take the plain versions, so the
comparison is plain against plain.
"""

import argparse
import json

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.ops import blend, rasterize_tiled
from easygaussiansplatting_tpu_torch.ops.kernels import preprocess, rasterize
from easygaussiansplatting_tpu_torch.probes import ab
from easygaussiansplatting_tpu_torch.utils.device import resolve_device, synchronize

TILE = 16
TILES = 2048
GX = 64  # tiles a row of the image


def product_exit(tau_in, us_k, cinv_k, alpha_k, color_k, mask_k, px, py):
    """blend_chunk_fwd with the exit transmittance taken as the product of
    the contributors' (1 - alpha'), the earlier shape."""
    color_add, _, cont_local = blend.blend_chunk_fwd(tau_in, us_k, cinv_k, alpha_k, color_k,
                                                     mask_k, px, py)
    ap, _ = blend.chunk_alpha(us_k, cinv_k, alpha_k, mask_k, px, py)
    m1 = ap >= blend.ALPHA_SKIP
    cum = torch.cumprod(torch.where(m1, 1.0 - ap, 1.0), dim=-2)
    excl = torch.cat([torch.ones_like(cum[..., :1, :]), cum[..., :-1, :]], dim=-2)
    contribute = m1 & (tau_in[..., None, :] * excl >= blend.TAU_STOP)
    tau_out = tau_in * torch.prod(torch.where(contribute, 1.0 - ap, 1.0), dim=-2)
    return color_add, tau_out, cont_local


def make_tiles(n_tiles, seed=0):
    """The tiles' table and binning as numpy: (us [N,2], cinv2ds [N,3],
    alphas [N], colors [N,3], patch_gsid [N], tile_start [T], tile_cnt [T])
    with N = n_tiles * 2 * K_CHUNK, entry j of tile t being gaussian
    t * 2 * K_CHUNK + j."""
    k = rasterize_tiled.K_CHUNK
    n = 2 * k
    rng = np.random.default_rng(seed)
    gx = min(n_tiles, GX)
    t = np.arange(n_tiles)
    origin = np.stack([(t % gx) * TILE, (t // gx) * TILE], axis=1).astype(np.float64)
    alphas = np.full((n_tiles, n), 0.5)
    alphas[:, 1:k] = rng.uniform(0.1, 0.3, (n_tiles, k - 1))
    # excl[:, j]: the transmittance in front of entry j + 1 over that after
    # entry 0. The stop falls in front of entry j + 1 where the transmittance
    # after entry 0 is tau1 = 1e-4 / excl[:, j], which entry 0's alpha'
    # (at most 0.99) reaches only where excl[:, j] < 0.01.
    excl = np.cumprod(np.concatenate([np.ones((n_tiles, 1)), 1.0 - alphas[:, 1:k - 1]], 1), 1)
    lo = np.argmax(excl <= 0.009, axis=1)
    hi = np.maximum(lo, (excl > 2e-4).sum(1) - 1)
    j = lo + (rng.uniform(size=n_tiles) * (hi - lo + 1)).astype(int)
    tau1 = 1e-4 / excl[t, j]
    # entry 0 centred on the tile's corner with conic eps * I: over the tile
    # maha runs from 0 to 450 eps and the transmittance after entry 0 from
    # tau1 - 150 ulps to tau1 + 150 ulps
    ulp = np.spacing(tau1.astype(np.float32)).astype(np.float64)
    alphas[:, 0] = 1.0 - tau1 + 150.0 * ulp
    eps = 600.0 * ulp / (alphas[:, 0] * 450.0)
    us = np.repeat(origin[:, None, :], n, axis=1)
    us[:, 1:] += 8.0
    cinv = np.zeros((n_tiles, n, 3))
    cinv[:, 0, 0] = cinv[:, 0, 2] = eps
    colors = rng.uniform(0.0, 1.0, (n_tiles, n, 3))
    f32 = lambda a, w: a.reshape(n_tiles * n, w).astype(np.float32)  # noqa: E731
    return (f32(us, 2), f32(cinv, 3), alphas.reshape(-1).astype(np.float32), f32(colors, 3),
            np.arange(n_tiles * n, dtype=np.int32), (t * n).astype(np.int32),
            np.full(n_tiles, n, np.int32))


def run(device="cuda", n_tiles=TILES):
    """Both exits against K4 and K5 on ``n_tiles`` tiles. Returns the
    result as a dict."""
    dev = resolve_device(device)
    us, cinv, alphas, colors, gsid, start, cnt = (torch.from_numpy(a).to(dev)
                                                  for a in make_tiles(n_tiles))
    table = preprocess.pack_table(us, cinv, alphas, colors, torch.zeros_like(alphas),
                                  torch.zeros_like(us))
    gx = min(n_tiles, GX)
    w, h = gx * TILE, -(-n_tiles // gx) * TILE
    args = (table, gsid, start, cnt)
    kw = dict(width=w, height=h)
    g_img = torch.randn((3, h, w), generator=torch.Generator().manual_seed(1)).to(dev)
    _, tau_k, cont_k = rasterize.rasterize_fwd(*args, **kw)
    grads_k = rasterize.rasterize_bwd(*args, g_img, tau_k, cont_k, **kw)
    out = {"tiles": n_tiles, "pixels": w * h, "k4_stopped": int((tau_k < blend.TAU_STOP).sum())}
    for name, fwd in (("product", product_exit), ("stop", blend.blend_chunk_fwd)):
        saved = rasterize_tiled.blend_chunk_fwd
        rasterize_tiled.blend_chunk_fwd = fwd
        try:
            _, tau_p, cont_p = rasterize.rasterize_plain(*args, **kw)
        finally:
            rasterize_tiled.blend_chunk_fwd = saved
        grads_p = rasterize.rasterize_bwd_plain(*args, g_img, tau_p, cont_p, **kw)
        scale = grads_p.abs().amax(1).clamp(min=1e-30)
        out[name] = {
            "resumed": int((cont_p > rasterize_tiled.K_CHUNK).sum()),
            "contrib_differs_from_k4": int((cont_p != cont_k).sum()),
            "grad_err_of_max": float(((grads_k - grads_p).abs().amax(1) / scale).max()),
        }
    synchronize(dev)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiles", type=int, default=TILES)
    a = ap.parse_args(argv)
    out = run(a.device, a.tiles)
    if torch.device(a.device).type == "cuda":
        out["card"] = ab.card()
    for name in ("product", "stop"):
        r = out[name]
        print(f"{name} exit: {r['resumed']} of {out['pixels']} pixels resumed by the second "
              f"chunk; contrib differs from K4's on {r['contrib_differs_from_k4']}; gradients "
              f"against K5's up to {r['grad_err_of_max']:.3e} of a row's max|want|")
    print(json.dumps(out))
    return 1 if out["stop"]["resumed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
