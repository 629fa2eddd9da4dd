"""The benchmark's inputs, made from its own frozen code: scenes, cameras and
the SfM-like initialisation.

Frozen copies of ``easygaussiansplatting_tpu_torch/data/synthetic.py``
(``look_at_camera``, ``make_synthetic_scene``), of ``bench_scene.py``'s
``sfm_init`` and of ``data/dataset.py``'s ``points_to_gaussians``: a later
change to the program cannot move the scene a cell measures. Cameras are
plain dicts (``Rcw``, ``tcw``, ``fx``, ``fy``, ``cx``, ``cy``, ``width``,
``height``, ``id``); the drivers turn them into the program's camera type.
"""

import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def look_at(pos, target, width, height, f, up=(0.0, 0.0, 1.0), cam_id=0):
    """Camera dict at ``pos`` looking at ``target`` (x right, y down, z forward)."""
    pos = np.asarray(pos, np.float64)
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    nrm = np.linalg.norm(right)
    if nrm < 1e-6:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
        nrm = np.linalg.norm(right)
    right /= nrm
    down = np.cross(fwd, right)
    rcw = np.stack([right, down, fwd], axis=0)
    return {"Rcw": rcw.astype(np.float32), "tcw": (-rcw @ pos).astype(np.float32),
            "fx": np.float32(f), "fy": np.float32(f), "cx": np.float32(width / 2.0),
            "cy": np.float32(height / 2.0), "width": int(width), "height": int(height),
            "id": int(cam_id)}


def orbit_camera(center, radius, azimuth, elevation, width, height, fov_f=0.9, lores_div=1):
    """The web viewer's orbit camera for one request: at 1/``lores_div`` of
    the size (64 x 48 at least) with the same field of view."""
    if lores_div > 1:
        width, height = max(64, width // lores_div), max(48, height // lores_div)
    center = np.asarray(center, np.float64)
    pos = center + float(radius) * np.array([
        math.cos(elevation) * math.cos(azimuth),
        math.cos(elevation) * math.sin(azimuth),
        math.sin(elevation)])
    return look_at(pos, center, width, height, fov_f * width)


def synthetic_scene(seed, n_gaussians, n_cams, width, height, radius=5.0, log_scale_mean=-1.9):
    """A random ground-truth gaussian cloud and a ring of cameras (numpy,
    float64; ``shs`` is the degree-0 RGB), bit-equal to the program's
    ``make_synthetic_scene`` on the same arguments."""
    rng = np.random.default_rng(seed)
    pws = rng.normal(size=(n_gaussians, 3)) * np.array([1.2, 1.2, 0.8])
    rots = rng.normal(size=(n_gaussians, 4))
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    scales = np.exp(rng.normal(size=(n_gaussians, 3)) * 0.3 + log_scale_mean)
    alphas = 0.3 + 0.6 / (1 + np.exp(-rng.normal(size=n_gaussians)))
    shs = rng.normal(size=(n_gaussians, 3)) * 0.8
    cams = []
    f = 0.9 * width
    for i in range(n_cams):
        a = 2 * np.pi * i / n_cams
        pos = np.array([radius * np.cos(a), radius * np.sin(a), 1.5 + 0.5 * np.sin(2 * a)])
        cams.append(look_at(pos, (0, 0, 0), width, height, f, cam_id=i))
    centers = np.stack([-c["Rcw"].T @ c["tcw"] for c in cams])
    scene_size = 1.1 * float(np.max(np.linalg.norm(centers - centers.mean(0), axis=1)))
    return {"pws": pws, "rots": rots, "scales": scales, "alphas": alphas, "shs": shs,
            "cameras": cams, "scene_size": scene_size}


def sfm_init(scene, n_gt, seed, frac=0.6, jitter=0.01):
    """SfM-like initial gaussians from the ground truth, as ``bench_scene``
    makes them: a ``frac`` subsample of the positions jittered by N(0,
    ``jitter``), colours quantised to uint8, then the reference's init
    recipe (identity rotations, alpha 0.8, isotropic scales = the nearest
    neighbour's squared distance clipped to [0.01, 3]). The subsample and
    the jitter come from ``seed``. Returns activated float32 arrays."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    keep = rng.permutation(len(scene["pws"]))[: int(frac * n_gt)]
    xyz = (scene["pws"][keep] + rng.normal(scale=jitter, size=(len(keep), 3))).astype(np.float32)
    rgb = np.clip((scene["shs"][keep] * SH_C0 + 0.5) * 255, 0, 255).astype(np.uint8)
    n = len(xyz)
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1.0
    d, _ = cKDTree(xyz).query(xyz, k=2)
    scales = np.repeat(np.clip(d[:, 1] ** 2, 0.01, 3.0).astype(np.float32)[:, None], 3, axis=1)
    return {"pws": xyz, "rots": rots, "scales": scales, "alphas": np.full(n, 0.8, np.float32),
            "shs": ((rgb.astype(np.float32) / 255.0) - 0.5) / np.float32(SH_C0)}


def device_scene(seed, n_gaussians, log_scale_mean, sh_rest_std, device, sh_degree):
    """A served scene of ``n_gaussians`` with SH degree ``sh_degree``, drawn
    on ``device`` by one ``torch.Generator`` in a few large calls: the
    distribution of :func:`synthetic_scene` (positions, rotations, scales,
    opacities, DC colours), and the higher coefficients N(0,
    ``sh_rest_std``). Returns float32 tensors pws [N,3], rots [N,4] (unit),
    scales [N,3], alphas [N], shs [N, 3 (sh_degree + 1)^2]."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    n = int(n_gaussians)
    rest = 3 * ((int(sh_degree) + 1) ** 2 - 1)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.float32)

    pws = normal(n, 3) * torch.tensor([1.2, 1.2, 0.8], device=device)
    rots = normal(n, 4)
    rots = rots / torch.linalg.vector_norm(rots, dim=1, keepdim=True)
    scales = torch.exp(normal(n, 3) * 0.3 + log_scale_mean)
    alphas = 0.3 + 0.6 / (1 + torch.exp(-normal(n)))
    shs = torch.cat([normal(n, 3) * 0.8, normal(n, rest) * sh_rest_std], dim=1)
    return {"pws": pws, "rots": rots, "scales": scales, "alphas": alphas, "shs": shs}


def view_scene(cfg, device, seed=None):
    """The served scene of a view configuration: :func:`device_scene` on
    its ``scene_seed`` (or ``seed``), ``gaussians``, ``log_scale_mean``,
    ``sh_rest_std`` and ``sh_degree``."""
    return device_scene(cfg["scene_seed"] if seed is None else seed, cfg["gaussians"],
                        cfg["log_scale_mean"], cfg["sh_rest_std"], device, cfg["sh_degree"])
