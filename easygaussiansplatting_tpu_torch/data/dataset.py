"""COLMAP scene dataset.

Port of easygaussiansplatting_tpu/data/dataset.py: parse the sparse/0 binary
model, load and resize the photos, scale the intrinsics by the resize ratio,
build the initial gaussians from the SfM points and compute the scene size.
Cameras and gaussians stay on the host as the JAX ones do; the photos come
back as float32 tensors [3,H,W] on ``device``, decoded and resized there by
data/image_io.py (nvJPEG for JPEG on a CUDA device, PIL on the CPU; the
port's own PNG decoder on both; a Pillow-exact resize).
"""

import dataclasses
import warnings
from pathlib import Path

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.data import native_loader
from easygaussiansplatting_tpu_torch.data.colmap import (
    qvec2rotmat,
    read_cameras_binary,
    read_images_binary,
    read_points3d_binary,
)
from easygaussiansplatting_tpu_torch.data.gau_io import SH_C0, arrays_to_recarray
from easygaussiansplatting_tpu_torch.data.image_io import load_rgb8, resized_size
from easygaussiansplatting_tpu_torch.models.camera import Camera
from easygaussiansplatting_tpu_torch.utils.device import resolve_device


def points_to_gaussians(xyz, rgb):
    """SfM points -> initial gaussians, as the JAX function builds them:
    identity rotations, alpha 0.8, SH0 = (rgb/255 - 0.5)/SH_C0, isotropic
    scales = the nearest neighbour's *squared* distance clipped to
    [0.01, 3] (scipy's cKDTree, as in JAX, so it is bit-equal)."""
    from scipy.spatial import cKDTree

    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    shs = ((np.asarray(rgb, np.float32) / 255.0) - 0.5) / SH_C0
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1.0
    alphas = np.full(n, 0.8, np.float32)
    d, _ = cKDTree(xyz).query(xyz, k=2)
    scales = np.clip(d[:, 1] ** 2, 0.01, 3.0).astype(np.float32)
    scales = np.repeat(scales[:, None], 3, axis=1)
    return arrays_to_recarray(xyz, rots, scales, alphas, shs)


@dataclasses.dataclass
class GSplatDataset:
    """cameras: list[Camera]; images: list of float32 tensors [3,H,W] in
    [0, 1]; gs: initial-gaussian recarray; scene_size: float."""

    cameras: list
    images: list
    gs: np.recarray
    scene_size: float
    image_paths: list = None  # source photo paths (set even when load_images=False)

    def __len__(self):
        return len(self.cameras)

    def __getitem__(self, i):
        return self.cameras[i], self.images[i]


# uint8 level -> float32 level / 255, divided by numpy as the JAX loader
# divides; a CUDA tensor divided by the scalar 255 is multiplied by its
# reciprocal instead, which is one ulp off for some levels
LEVELS = np.arange(256, dtype=np.float32) / np.float32(255.0)


def load_image(path, resize_rate=1.0, device="cuda"):
    """A photo as a float32 tensor [3,H,W] in [0, 1] on ``device``: the JAX
    ``load_image``'s values (uint8 / 255 in float32, bit-equal on every
    device), resized as PIL's ``Image.resize`` resizes it."""
    rgb = load_rgb8(path, resize_rate, device)
    levels = torch.from_numpy(LEVELS).to(rgb.device)
    return levels[rgb.permute(2, 0, 1).to(torch.int64)].contiguous()


def load_colmap_dataset(path, resize_rate=1.0, load_images=True, cache_points=True,
                        use_native=None, device="cuda"):
    """`use_native` selects the C++ parser (native/colmap_reader.cc); None
    uses it when it builds, else the pure-Python readers, with a warning
    that says why (data/native_loader.py). Reads and writes the JAX
    package's ``sparse/0/points3D.npy`` cache."""
    dev = resolve_device(device)
    if use_native is None:
        use_native = native_loader.available()
    read_cams = native_loader.read_cameras_binary if use_native else read_cameras_binary
    read_imgs = native_loader.read_images_binary if use_native else read_images_binary
    read_pts = native_loader.read_points3d_binary if use_native else read_points3d_binary

    path = Path(path)
    sparse = path / "sparse" / "0"
    cameras = read_cams(sparse / "cameras.bin")
    images_meta = read_imgs(sparse / "images.bin")

    cams, imgs, img_paths = [], [], []
    for im in sorted(images_meta.values(), key=lambda x: x.id):
        cp = cameras[im.camera_id]
        fx, fy, cx, cy = cp.intrinsics
        im_path = path / "images" / im.name
        img_paths.append(im_path)
        if load_images:
            img = load_image(im_path, resize_rate, dev)
            h, w = img.shape[1], img.shape[2]
            imgs.append(img)
        else:
            w, h = resized_size(cp.width, cp.height, resize_rate)
        w_scale, h_scale = w / cp.width, h / cp.height
        cams.append(
            Camera.from_dict(
                {
                    "Rcw": qvec2rotmat(im.qvec),
                    "tcw": im.tvec,
                    "fx": fx * w_scale, "fy": fy * h_scale,
                    "cx": cx * w_scale, "cy": cy * h_scale,
                    "width": w, "height": h, "id": im.id,
                }
            )
        )

    npy_cache = sparse / "points3D.npy"
    gs = None
    if cache_points and npy_cache.exists():
        try:
            gs = np.load(npy_cache)
        except (OSError, ValueError) as e:  # unreadable cache: rebuilt from points3D.bin
            warnings.warn(f"ignoring unreadable {npy_cache}: {e}")
    if gs is None:
        xyz, rgb, _ = read_pts(sparse / "points3D.bin")
        gs = points_to_gaussians(xyz, rgb)
        if cache_points:
            try:
                np.save(npy_cache, gs)
            except OSError:  # a read-only scene: the cache is an optimisation
                pass

    twcs = np.stack([np.asarray(c.twc) for c in cams])
    scene_size = 1.1 * float(np.max(np.linalg.norm(twcs - twcs.mean(0), axis=1)))
    return GSplatDataset(cameras=cams, images=imgs, gs=gs, scene_size=scene_size,
                         image_paths=img_paths)
