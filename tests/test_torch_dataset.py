"""PyTorch port: the COLMAP dataset (data/dataset.py) against the JAX
package's, on fake scenes written as tests/test_data_io.py writes one.

Every comparison is exact (np.array_equal). The JAX side loads with
``use_native=False`` (its native loader would run ``make -C native``), and
every parity test passes ``cache_points=False`` to both sides, so the
nearest-neighbour step of ``points_to_gaussians`` really is compared.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from easygaussiansplatting_tpu.data.dataset import load_colmap_dataset as jax_load
from easygaussiansplatting_tpu.data.dataset import points_to_gaussians as jax_points
from easygaussiansplatting_tpu_torch.data import colmap
from easygaussiansplatting_tpu_torch.data.dataset import (
    GSplatDataset,
    load_colmap_dataset,
    points_to_gaussians,
)
from easygaussiansplatting_tpu_torch.data.fixtures import write_colmap_scene

CAM_FIELDS = ("Rcw", "tcw", "fx", "fy", "cx", "cy")


def _scene(root, rng, fmt="png", n_imgs=3, n_pts=50, w=64, h=48):
    """Fake scene: two cameras (PINHOLE and SIMPLE_RADIAL) of one size,
    random poses, uniform-noise photos (PNG by the port's writer, or JPEG
    by PIL), random points."""
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", w, h, np.array([60.0, 58.0, w / 2, h / 2])),
            2: colmap.ColmapCamera(2, "SIMPLE_RADIAL", w, h,
                                   np.array([55.0, w / 2 - 1, h / 2 + 1, 0.01]))}
    images, photos = {}, {}
    for i in range(1, n_imgs + 1):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        name = f"im{i}.{fmt}"
        images[i] = colmap.ColmapImage(i, q, rng.normal(size=3), 1 + i % 2, name)
        photos[name] = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
    xyz = rng.normal(size=(n_pts, 3))
    rgb = (rng.uniform(size=(n_pts, 3)) * 255).astype(np.uint8)
    if fmt == "png":
        write_colmap_scene(root, cams, images, xyz, rgb, photos)
    else:
        write_colmap_scene(root, cams, images, xyz, rgb)
        for name, arr in photos.items():
            Image.fromarray(arr).save(root / "images" / name, quality=85)
    return xyz, rgb


def _same_dataset(got, want, images=True):
    assert isinstance(got, GSplatDataset) and len(got) == len(want)
    for cg, cw in zip(got.cameras, want.cameras):
        assert (cg.width, cg.height, cg.id) == (cw.width, cw.height, int(cw.id))
        for f in CAM_FIELDS:
            a, b = np.asarray(getattr(cg, f)), np.asarray(getattr(cw, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    if images:
        for ig, iw in zip(got.images, want.images):
            assert ig.dtype == torch.float32 and np.array_equal(ig.numpy(), iw)
    assert got.gs.dtype == want.gs.dtype
    for k in got.gs.dtype.names:
        assert np.array_equal(got.gs[k], want.gs[k]), k
    assert got.scene_size == want.scene_size
    assert [p.name for p in got.image_paths] == [p.name for p in want.image_paths]


@pytest.mark.parametrize("n", [2, 3, 40, 257])
def test_points_to_gaussians_matches_jax(n):
    """Bit-equal to JAX, duplicate points (distance 0, scale clipped to
    0.01) and far points (clipped to 3) included."""
    rng = np.random.default_rng(n)
    xyz = rng.normal(size=(n, 3)) * 2.0
    xyz[n // 2] = xyz[0]
    xyz[-1] = [40.0, 0, 0]
    rgb = rng.integers(0, 256, size=(n, 3)).astype(np.uint8)
    got, want = points_to_gaussians(xyz, rgb), jax_points(xyz, rgb)
    assert got.dtype == want.dtype
    for k in want.dtype.names:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("fmt", ["png", "jpg"])
def test_load_colmap_dataset_matches_jax(tmp_path, rng, fmt, use_native):
    """Cameras (intrinsics scaled by the resize), the photos decoded and
    resized on the CPU, the SfM gaussians and scene_size: equal to JAX's at
    resize rates 0.5 and 0.3, with the port's native and Python readers."""
    _scene(tmp_path, rng, fmt)
    for rate in (0.5, 0.3):
        got = load_colmap_dataset(tmp_path, resize_rate=rate, cache_points=False,
                                  use_native=use_native, device="cpu")
        want = jax_load(tmp_path, resize_rate=rate, cache_points=False, use_native=False)
        _same_dataset(got, want)
        assert got.images[0].shape == (3, round(48 * rate), round(64 * rate))
    assert not (tmp_path / "sparse" / "0" / "points3D.npy").exists()


def test_points_cache_written_by_jax_is_read(tmp_path, rng):
    """A points3D.npy the JAX package wrote is what the port loads: with
    points3D.bin gone it still loads, equal to JAX's; a cache the port
    writes loads in JAX the same."""
    _scene(tmp_path, rng)
    want = jax_load(tmp_path, resize_rate=0.5, cache_points=True, use_native=False)
    cache = tmp_path / "sparse" / "0" / "points3D.npy"
    assert cache.exists()
    (tmp_path / "sparse" / "0" / "points3D.bin").unlink()
    _same_dataset(load_colmap_dataset(tmp_path, resize_rate=0.5, device="cpu"), want)

    other = tmp_path / "other"
    _scene(other, np.random.default_rng(5))
    mine = load_colmap_dataset(other, resize_rate=0.5, device="cpu")
    assert (other / "sparse" / "0" / "points3D.npy").exists()
    (other / "sparse" / "0" / "points3D.bin").unlink()
    _same_dataset(mine, jax_load(other, resize_rate=0.5, use_native=False))


@pytest.mark.parametrize("rate", [1.0, 0.5, 0.3, 0.25, 0.123])
def test_load_images_false_sizes_match_jax(tmp_path, rng, rate):
    """Without photos, the sizes come from the camera and the rate:
    max(1, round(side * rate)), as JAX computes them."""
    _scene(tmp_path, rng, w=97, h=61)
    got = load_colmap_dataset(tmp_path, resize_rate=rate, load_images=False,
                              cache_points=False, device="cpu")
    want = jax_load(tmp_path, resize_rate=rate, load_images=False, cache_points=False,
                    use_native=False)
    assert got.images == [] and want.images == []
    _same_dataset(got, want, images=False)
