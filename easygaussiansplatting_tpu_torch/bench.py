"""Headline benchmark of the PyTorch / CUDA port: forward+backward
rasterisation throughput on one device.

Port of the repository's root bench.py, with its workload: the synthetic
scene of seed 0 with 65,536 gaussians (``log_scale_mean`` -3.6, splats of a
few pixels) at the reference evaluation resolution 979x546, rendered through
the full differentiable pipeline and the L1/DSSIM loss at the patch budget
557,056 and row budget 229,376 (``EGS_MAX_PATCHES`` and ``EGS_MAX_ROWS``
override them). With ``--device cpu`` it takes the JAX bench's CPU smoke
sizing (160x112, 1,024 gaussians, 2^14 patches). Prints ONE JSON line:

    {"metric": "fwd_bwd_throughput", "value": N, "unit": "Mpix/s",
     "vs_baseline": N, "fwd_throughput": N, "device": "..."}

``vs_baseline`` is against the JAX bench's fixed anchor of 10 Mpix/s. Each
time is the best of 3 trials of 10 steps, each trial ending in a
``torch.cuda.synchronize()`` (1 trial of 3 on the CPU).

    python -m easygaussiansplatting_tpu_torch.bench [--device cpu]
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene
from easygaussiansplatting_tpu_torch.ops.loss import gau_loss
from easygaussiansplatting_tpu_torch.ops.rasterize import render
from easygaussiansplatting_tpu_torch.utils.device import resolve_device

BASELINE_ANCHOR_MPIX_S = 10.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    width, height, n_gaussians = (979, 546, 65536) if on_card else (160, 112, 1024)
    max_patches = int(os.environ.get("EGS_MAX_PATCHES", "557056")) if on_card else 2**14
    max_rows = int(os.environ.get("EGS_MAX_ROWS", "229376")) if on_card else None

    scene = make_synthetic_scene(seed=0, n_gaussians=n_gaussians, n_cams=1, width=width,
                                 height=height, log_scale_mean=-3.6)
    cam = scene["cameras"][0]
    shs = np.zeros((n_gaussians, 48), np.float32)
    shs[:, :3] = scene["shs"]
    params = [torch.as_tensor(np.asarray(a, np.float32), device=dev).requires_grad_()
              for a in (scene["pws"], shs, scene["alphas"], scene["scales"], scene["rots"])]
    gt = torch.zeros((3, height, width), dtype=torch.float32, device=dev)
    kw = dict(sh_degree=3, max_patches=max_patches, max_rows=max_rows, device=dev)

    def step():
        image, _ = render(*params, cam, **kw)
        loss = gau_loss(image, gt)
        return loss, torch.autograd.grad(loss, params)

    def fwd_step():
        image, _ = render(*params, cam, need_grads=False, **kw)
        return image.mean()

    # refuse a budget that truncates work: a dropping budget renders a
    # different image and would look faster
    _, aux = render(*params, cam, need_grads=False, **kw)
    dropped = int(aux["binning"]["n_dropped"]) + int(aux["binning"]["rows_dropped"])
    if dropped:
        raise SystemExit(f"budget drops {dropped} patches/rows: not benchable")
    step()
    fwd_step()

    iters, trials = (10, 3) if on_card else (3, 1)

    def best_of(fn):
        best = float("inf")
        for _ in range(trials):
            if on_card:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            if on_card:
                torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        return best

    dt = best_of(step)
    dt_fwd = best_of(fwd_step)
    mpix_s = width * height * iters / dt / 1e6
    fwd_mpix_s = width * height * iters / dt_fwd / 1e6
    print(json.dumps({
        "metric": "fwd_bwd_throughput",
        "value": round(mpix_s, 3),
        "unit": "Mpix/s",
        "vs_baseline": round(mpix_s / BASELINE_ANCHOR_MPIX_S, 3),
        "fwd_throughput": round(fwd_mpix_s, 3),
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
    }))


if __name__ == "__main__":
    main()
