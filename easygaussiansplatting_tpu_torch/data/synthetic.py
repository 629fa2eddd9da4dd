"""Synthetic scene generation for tests, the train CLI and the chip smoke run.

Port of easygaussiansplatting_tpu/data/synthetic.py. The scene is numpy on
both sides, so the same seed gives bit-equal arrays and cameras; the
ground-truth images are rendered by the port.
"""

import numpy as np

from easygaussiansplatting_tpu_torch.models import Camera
from easygaussiansplatting_tpu_torch.ops.rasterize import render


def look_at_camera(pos, target, width, height, f, up=(0.0, 0.0, 1.0), cam_id=0):
    """Camera at `pos` looking at `target` (x right, y down, z forward)."""
    pos = np.asarray(pos, np.float64)
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(fwd, up)
    nrm = np.linalg.norm(right)
    if nrm < 1e-6:  # forward parallel to up
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
        nrm = np.linalg.norm(right)
    right /= nrm
    down = np.cross(fwd, right)
    Rcw = np.stack([right, down, fwd], axis=0)
    tcw = -Rcw @ pos
    return Camera.from_dict(
        {
            "Rcw": Rcw, "tcw": tcw, "fx": f, "fy": f,
            "cx": width / 2.0, "cy": height / 2.0,
            "width": width, "height": height, "id": cam_id,
        }
    )


def make_synthetic_scene(seed=0, n_gaussians=96, n_cams=6, width=64, height=48,
                         radius=5.0, log_scale_mean=-1.9):
    """Random ground-truth Gaussian cloud + ring of cameras.

    `log_scale_mean` controls splat size: the test default (-1.9) gives large
    overlapping blobs; -3.6 gives splats of a few pixels, the patch
    statistics of a trained scene.

    Returns dict with arrays (pws, rots, scales, alphas, shs deg-0, float64),
    cameras (list of Camera), scene_size.
    """
    rng = np.random.default_rng(seed)
    pws = rng.normal(size=(n_gaussians, 3)) * np.array([1.2, 1.2, 0.8])
    rots = rng.normal(size=(n_gaussians, 4))
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    scales = np.exp(rng.normal(size=(n_gaussians, 3)) * 0.3 + log_scale_mean)
    alphas = 0.3 + 0.6 / (1 + np.exp(-rng.normal(size=n_gaussians)))
    shs = rng.normal(size=(n_gaussians, 3)) * 0.8  # degree-0 RGB

    cams = []
    f = 0.9 * width
    for i in range(n_cams):
        a = 2 * np.pi * i / n_cams
        pos = np.array([radius * np.cos(a), radius * np.sin(a), 1.5 + 0.5 * np.sin(2 * a)])
        cams.append(look_at_camera(pos, (0, 0, 0), width, height, f, cam_id=i))

    centers = np.stack([np.asarray(c.twc) for c in cams])
    scene_size = 1.1 * float(np.max(np.linalg.norm(centers - centers.mean(0), axis=1)))
    return {
        "pws": pws, "rots": rots, "scales": scales, "alphas": alphas, "shs": shs,
        "cameras": cams, "scene_size": scene_size,
    }


def render_gt_images(scene, config=None, device="cuda"):
    """The ground-truth images [3,H,W] of the scene's cameras, rendered by
    the port on ``device`` (with the config's backend and patch budget when
    one is given)."""
    kw = {} if config is None else dict(backend=config.backend, max_patches=config.max_patches)
    args = [scene[k] for k in ("pws", "shs", "alphas", "scales", "rots")]
    return [render(*args, cam, need_grads=False, device=device, **kw)[0]
            for cam in scene["cameras"]]
