"""Headless turntable rendering, and dataset cameras drawn as gaussians.

Port of easygaussiansplatting_tpu/viewer/headless.py: deterministic orbit
camera paths rendered server-side (``orbit_cameras``, ``render_turntable``),
the reference viewer's camera overlays as ordinary gaussians
(``camera_markers``, ``_seg_gaussians``, ``camera_frusta``), and the frames
written as an animated GIF (utils/gif.py: a fixed palette, where the JAX
function calls PIL's adaptive one) or as PNGs (``save_png``). Every frame
goes through the port's ``ops/rasterize.render``: on the card K1, K3's three
calls and K4 once a frame.
"""

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.data.gau_io import (
    SH_C0,
    matrix_to_quaternion,
    recarray_to_arrays,
)
from easygaussiansplatting_tpu_torch.data.synthetic import look_at_camera
from easygaussiansplatting_tpu_torch.ops.rasterize import render
from easygaussiansplatting_tpu_torch.utils.device import resolve_device
from easygaussiansplatting_tpu_torch.utils.gif import save_gif
from easygaussiansplatting_tpu_torch.utils.image import save_png, to_uint8

__all__ = ["orbit_cameras", "render_turntable", "save_gif", "camera_markers", "camera_frusta",
           "save_frames"]


def orbit_cameras(center, radius, n_frames=60, width=640, height=480, elevation=0.35, f=None,
                  up=(0.0, 0.0, 1.0)):
    """Ring of cameras orbiting `center` at `radius`. `elevation` is the
    height of the ring above center in units of radius."""
    center = np.asarray(center, np.float64)
    f = f or 0.9 * width
    s = np.sqrt(1.0 + elevation**2)  # unit-norm offset: |pos - center| == radius
    cams = []
    for i in range(n_frames):
        a = 2.0 * np.pi * i / n_frames
        pos = center + (radius / s) * np.array([np.cos(a), np.sin(a), elevation])
        cams.append(look_at_camera(pos, center, width, height, f, up=up, cam_id=i))
    return cams


def render_turntable(gs, cameras=None, *, backend="auto", max_patches=2**20, sh_degree=None,
                     device="cuda", **orbit_kw):
    """Render a gaussian recarray (or dict of arrays) around its centroid on
    ``device``: its arrays go there once, then every camera renders from
    them. Returns a list of [3,H,W] float32 numpy frames."""
    dev = resolve_device(device)
    a = gs if isinstance(gs, dict) else recarray_to_arrays(gs)
    pws = np.asarray(a["pws"], np.float32)
    if cameras is None:
        center = pws.mean(0)
        radius = 2.5 * float(np.percentile(np.linalg.norm(pws - center, axis=1), 90))
        cameras = orbit_cameras(center, radius, **orbit_kw)

    shs = np.asarray(a["shs"], np.float32).reshape(len(pws), -1)
    if sh_degree is None:
        sh_degree = int(np.sqrt(max(1, shs.shape[1] // 3))) - 1
    args = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev) for x in (
        pws, shs, np.asarray(a["alphas"], np.float32).reshape(-1), a["scales"], a["rots"])]
    frames = []
    for cam in cameras:
        img, _ = render(*args, cam, backend=backend, max_patches=max_patches,
                        sh_degree=sh_degree, need_grads=False, device=dev)
        frames.append(img.cpu().numpy())
    return frames


def camera_markers(cameras, size_frac=0.01, color=(1.0, 0.3, 0.1)):
    """Small bright gaussians at camera centres: a dict of arrays to
    concatenate onto a scene's gaussians."""
    centers = np.stack([np.asarray(c.twc, np.float64) for c in cameras])
    n = len(centers)
    spread = float(np.max(np.linalg.norm(centers - centers.mean(0), axis=1))) or 1.0
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1.0
    return {
        "pws": centers.astype(np.float32),
        "rots": rots,
        "scales": np.full((n, 3), size_frac * spread, np.float32),
        "alphas": np.full(n, 0.95, np.float32),
        "shs": np.tile(((np.asarray(color, np.float32) - 0.5) / SH_C0), (n, 1)),
    }


def _seg_gaussians(p0, p1, thick, color, alpha=0.95):
    """One anisotropic gaussian stretched along the segment p0->p1: lines
    ride the ordinary splatting renderer."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    d = p1 - p0
    length = float(np.linalg.norm(d)) or 1e-6
    x = d / length
    ref = np.array([0.0, 0.0, 1.0]) if abs(x[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    y = np.cross(x, ref)
    y /= np.linalg.norm(y)
    z = np.cross(x, y)
    rot = matrix_to_quaternion(np.stack([x, y, z], axis=1)[None])[0]
    return {
        "pws": ((p0 + p1) / 2).astype(np.float32)[None],
        "rots": rot[None],
        "scales": np.asarray([[length / 4.0, thick, thick]], np.float32),
        "alphas": np.asarray([alpha], np.float32),
        "shs": ((np.asarray(color, np.float32) - 0.5) / SH_C0)[None],
    }


def camera_frusta(cameras, images=None, plane_frac=0.08, tex_wh=(24, 16), line_frac=0.0035,
                  color=(1.0, 0.6, 0.15)):
    """Oriented, image-textured camera frusta as gaussians: each camera a
    wireframe (apex at its centre, image plane at a fixed depth, proportions
    from its intrinsics) with its photograph as a grid of flat gaussian
    texels on the image plane.

    `images`: optional list parallel to `cameras` of [3,H,W] float arrays
    (None entries allowed) for the image-plane texture.
    """
    centers = np.stack([np.asarray(c.twc, np.float64) for c in cameras])
    spread = float(np.max(np.linalg.norm(centers - centers.mean(0), axis=1))) or 1.0
    d = plane_frac * spread
    thick = line_frac * spread
    blocks = []
    for ci, cam in enumerate(cameras):
        Rwc = np.asarray(cam.Rcw, np.float64).T
        t = np.asarray(cam.twc, np.float64)
        w, h = float(cam.width), float(cam.height)
        fx, fy = float(cam.fx), float(cam.fy)
        cx, cy = float(cam.cx), float(cam.cy)

        def to_world(px, py):
            dir_cam = np.array([(px - cx) / fx, (py - cy) / fy, 1.0]) * d
            return Rwc @ dir_cam + t

        corners = [to_world(x, y) for x, y in [(0, 0), (w, 0), (w, h), (0, h)]]
        for c0 in corners:  # apex -> image plane corners
            blocks.append(_seg_gaussians(t, c0, thick, color))
        for i in range(4):  # image plane edges
            blocks.append(_seg_gaussians(corners[i], corners[(i + 1) % 4], thick, color))

        img = images[ci] if images is not None and ci < len(images) else None
        if img is not None:
            tw, th = tex_wh
            arr = np.asarray(img, np.float32)  # [3,H,W]
            ih, iw = arr.shape[1], arr.shape[2]
            ys = np.clip(((np.arange(th) + 0.5) * ih / th).astype(int), 0, ih - 1)
            xs = np.clip(((np.arange(tw) + 0.5) * iw / tw).astype(int), 0, iw - 1)
            thumb = arr[:, ys][:, :, xs]  # [3,th,tw] nearest-sampled
            u = (np.arange(tw) + 0.5) * w / tw
            v = (np.arange(th) + 0.5) * h / th
            uu, vv = np.meshgrid(u, v)  # [th,tw]
            dirs = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu)], axis=-1) * d
            pws = dirs.reshape(-1, 3) @ Rwc.T + t
            n = pws.shape[0]
            # texel half-extents on the plane (in world units), thin normal
            sx = 0.7 * d * w / (fx * tw)
            sy = 0.7 * d * h / (fy * th)
            rot = matrix_to_quaternion(Rwc[None])[0]
            rgb = thumb.reshape(3, -1).T  # [n,3]
            blocks.append({
                "pws": pws.astype(np.float32),
                "rots": np.tile(rot, (n, 1)),
                "scales": np.tile(np.asarray([sx, sy, 1e-4 * spread], np.float32), (n, 1)),
                "alphas": np.full(n, 0.98, np.float32),
                "shs": ((rgb - 0.5) / SH_C0).astype(np.float32),
            })
    return {
        k: np.concatenate([b[k] for b in blocks]).astype(np.float32)
        for k in ("pws", "rots", "scales", "alphas", "shs")
    }


def save_frames(prefix, frames):
    """Write [3,H,W] float frames as PNGs ``{prefix}0000.png``, ..."""
    for i, f in enumerate(frames):
        save_png(f"{prefix}{i:04d}.png", to_uint8(f))
