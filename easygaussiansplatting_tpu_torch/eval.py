"""Evaluate a trained Gaussian model: PSNR / SSIM / L1 over the scene's views.

Port of the repository's root eval.py, run as

    python -m easygaussiansplatting_tpu_torch.eval --gs output/final.npy --path <colmap_dir>
    python -m easygaussiansplatting_tpu_torch.eval --gs output/final.npy --synthetic
    python -m easygaussiansplatting_tpu_torch.eval --gs output/final.npy --synthetic --device cpu

``--path`` evaluates against a COLMAP scene's photos, loaded at
``--resize-rate`` (default 0.25) by data/dataset.py. The synthetic scene is
the JAX CLI's (512 gaussians, 8 views at 128x96), its ground truth rendered
by the port. Prints one line per view and the means, as the JAX CLI does.
"""

import argparse

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.data.dataset import load_colmap_dataset
from easygaussiansplatting_tpu_torch.data.gau_io import load_gs, recarray_to_arrays
from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene, render_gt_images
from easygaussiansplatting_tpu_torch.ops.loss import ssim
from easygaussiansplatting_tpu_torch.ops.rasterize import render
from easygaussiansplatting_tpu_torch.utils.device import resolve_device
from easygaussiansplatting_tpu_torch.utils.image import psnr


def evaluate_views(gaussians, cameras, images, *, backend="auto", max_patches=2**20,
                   sh_degree=3, device="cuda", log_fn=print):
    """PSNR, SSIM and L1 of ``gaussians`` (pws, shs, alphas, scales, rots:
    arrays or tensors) rendered from each camera against its image [3,H,W],
    the render clipped to [0, 1] as in JAX eval.py. Logs one line per view;
    returns the list of (psnr, ssim, l1) floats."""
    dev = resolve_device(device)
    rows = []
    for cam, gt in zip(cameras, images):
        img, _ = render(*gaussians, cam, need_grads=False, backend=backend,
                        max_patches=max_patches, sh_degree=sh_degree, device=dev)
        gt = torch.as_tensor(gt, dtype=torch.float32, device=dev)
        img = torch.clamp(img, 0.0, 1.0)
        rows.append((float(psnr(img, torch.clamp(gt, 0, 1))), float(ssim(img, gt)),
                     float(torch.mean(torch.abs(img - gt)))))
        log_fn(f"view {cam.id:4d}: psnr {rows[-1][0]:6.2f}  ssim {rows[-1][1]:.4f}  "
               f"l1 {rows[-1][2]:.4f}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--gs", required=True, help="trained gaussians (.ply/.npy)")
    ap.add_argument("--path", help="COLMAP dataset directory")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--resize-rate", type=float, default=0.25)
    ap.add_argument("--backend", default="auto", choices=["auto", "cuda", "tiled"])
    ap.add_argument("--max-patches", type=int, default=2**20)
    ap.add_argument("--max-views", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.synthetic:
        dev = resolve_device(args.device)
        scene = make_synthetic_scene(seed=0, n_gaussians=512, n_cams=8, width=128, height=96)
        cameras = scene["cameras"]
        images = render_gt_images(scene, device=dev)
    elif args.path:
        dev = resolve_device(args.device)
        ds = load_colmap_dataset(args.path, resize_rate=args.resize_rate, device=dev)
        cameras, images = ds.cameras, ds.images
    else:
        ap.error("need --path or --synthetic")

    a = recarray_to_arrays(load_gs(args.gs))
    shs = a["shs"].reshape(len(a["pws"]), -1)
    degree = int(np.sqrt(max(1, shs.shape[1] // 3))) - 1
    gaussians = (a["pws"], shs, np.reshape(a["alphas"], -1), a["scales"], a["rots"])

    n = len(cameras) if args.max_views is None else min(args.max_views, len(cameras))
    rows = evaluate_views(gaussians, cameras[:n], images[:n], backend=args.backend,
                          max_patches=args.max_patches, sh_degree=degree, device=dev)
    arr = np.array(rows)
    print(f"\nmean over {n} views: psnr {arr[:, 0].mean():.2f}  "
          f"ssim {arr[:, 1].mean():.4f}  l1 {arr[:, 2].mean():.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
