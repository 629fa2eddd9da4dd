"""The interactive viewer's frame rates: full resolution and drag preview.

Port of the repository's ``scripts/viewer_fps.py``: drives the
``SceneRenderer.render`` that the web viewer serves frames with
(viewer/server.py), a render and the uint8 frame's copy back to the host per
frame, which is what a browser request costs without HTTP and PNG. The
scene is the bench's: ``make_synthetic_scene`` seed 0, 65,536 gaussians,
``log_scale_mean`` -3.6, SH degree 3 (padded with zeros), 979x546,
``max_patches`` 573,440. The drag preview renders at 1/LORES_DIV of the
size while the mouse is down. ``--device cpu`` takes a smoke size (1,024
gaussians at 160x112, 2^14 patches, 1 trial of 2 frames), as the port's
bench does.

Prints, per path, the size, the ms a frame (best of 3 trials of 10 frames,
after one warm frame; the host's clock, each frame ending in its copy to
the host) and the frames a second.

    python -m easygaussiansplatting_tpu_torch.viewer_fps [--device cpu]
"""

import argparse
import time

import numpy as np

from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene
from easygaussiansplatting_tpu_torch.utils.device import resolve_device
from easygaussiansplatting_tpu_torch.viewer.server import SceneRenderer

FULL = (979, 546, 65536, 573440)  # width, height, gaussians, max_patches
SMOKE = (160, 112, 1024, 2**14)


def scene_gaussians(n, width, height):
    """The bench scene's gaussians with their SH padded to degree 3."""
    scene = make_synthetic_scene(seed=0, n_gaussians=n, n_cams=1, width=width, height=height,
                                 log_scale_mean=-3.6)
    shs = np.zeros((n, 48), np.float32)
    shs[:, :3] = scene["shs"]
    return {"pws": scene["pws"], "shs": shs, "alphas": scene["alphas"],
            "scales": scene["scales"], "rots": scene["rots"]}


def measure(renderer, width, height, iters=10, trials=3):
    """{label: (frame width, frame height, seconds a frame)} for the full
    and the drag-preview path: the best of ``trials`` runs of ``iters``
    frames each, after one warm frame."""
    out = {}
    for label, lores in (("full", False), ("drag-preview", True)):
        kw = dict(width=width, height=height, lores=lores)
        renderer.render(**kw)  # warm
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            for _ in range(iters):
                frame = renderer.render(azimuth=0.01, **kw)
            best = min(best, (time.perf_counter() - t0) / iters)
        out[label] = (frame.shape[1], frame.shape[0], best)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    width, height, n, max_patches = FULL if dev.type == "cuda" else SMOKE
    r = SceneRenderer(scene_gaussians(n, width, height), max_patches=max_patches, device=dev)
    iters, trials = (10, 3) if dev.type == "cuda" else (2, 1)
    results = measure(r, width, height, iters, trials)
    for label, (w, h, best) in results.items():
        print(f"{label:14s} {w}x{h:4d}  {best * 1e3:7.2f} ms/frame  {1.0 / best:6.1f} fps",
              flush=True)
    return results


if __name__ == "__main__":
    main()
