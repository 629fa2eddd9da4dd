"""PyTorch port: the COLMAP readers and writers (data/colmap.py) and the
native parser (data/native_loader.py) against the JAX package's.

The JAX side always reads with its pure-Python readers: its native loader
runs ``make -C native`` when asked whether it is available, and these tests
must not start that build. The port's native library is its own, built
into build/native/ by g++ through a per-process temporary file.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from easygaussiansplatting_tpu.data import colmap as jax_colmap
from easygaussiansplatting_tpu_torch.data import colmap, native_loader
from easygaussiansplatting_tpu_torch.data.dataset import load_colmap_dataset


def _model(rng, n_imgs=4, n_pts=200):
    cams = {
        1: colmap.ColmapCamera(1, "PINHOLE", 64, 48, np.array([60.0, 59.0, 32.0, 24.0])),
        2: colmap.ColmapCamera(2, "SIMPLE_RADIAL", 80, 60, np.array([70.0, 40.0, 30.0, 0.01])),
        5: colmap.ColmapCamera(5, "OPENCV", 33, 17, rng.normal(size=8)),
    }
    images = {}
    for i in range(1, n_imgs + 1):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        images[i] = colmap.ColmapImage(i, q, rng.normal(size=3), 1 + i % 2, f"img_{i:03d}.png")
    xyz = rng.normal(size=(n_pts, 3))
    rgb = rng.integers(0, 256, size=(n_pts, 3)).astype(np.uint8)
    err = rng.uniform(size=n_pts)
    return cams, images, xyz, rgb, err


def _write(module, d, cams, images, xyz, rgb, err):
    d.mkdir(parents=True, exist_ok=True)
    cam_t = {k: module.ColmapCamera(c.id, c.model, c.width, c.height, c.params)
             for k, c in cams.items()}
    img_t = {k: module.ColmapImage(m.id, m.qvec, m.tvec, m.camera_id, m.name)
             for k, m in images.items()}
    module.write_cameras_binary(d / "cameras.bin", cam_t)
    module.write_images_binary(d / "images.bin", img_t)
    module.write_points3d_binary(d / "points3D.bin", xyz, rgb, err)


def _same_cameras(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k].id, a[k].model, a[k].width, a[k].height) == \
            (b[k].id, b[k].model, b[k].width, b[k].height)
        assert np.array_equal(a[k].params, b[k].params)


def _same_images(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k].id, a[k].camera_id, a[k].name) == (b[k].id, b[k].camera_id, b[k].name)
        assert np.array_equal(a[k].qvec, b[k].qvec) and np.array_equal(a[k].tvec, b[k].tvec)


def test_writers_write_the_jax_bytes_and_readers_agree(tmp_path, rng):
    """Both writers give the same bytes; the port's Python readers read
    them exactly as the JAX readers do (np.array_equal throughout)."""
    model = _model(rng)
    _write(jax_colmap, tmp_path / "jax", *model)
    _write(colmap, tmp_path / "port", *model)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    d = tmp_path / "jax"
    _same_cameras(colmap.read_cameras_binary(d / "cameras.bin"),
                  jax_colmap.read_cameras_binary(d / "cameras.bin"))
    _same_images(colmap.read_images_binary(d / "images.bin"),
                 jax_colmap.read_images_binary(d / "images.bin"))
    for got, want in zip(colmap.read_points3d_binary(d / "points3D.bin"),
                         jax_colmap.read_points3d_binary(d / "points3D.bin")):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_native_readers_match_jax_python_readers(tmp_path, rng):
    """The port's native library over native/colmap_reader.cc against the
    JAX package's pure-Python readers: every field equal."""
    model = _model(rng, n_imgs=7, n_pts=333)
    _write(jax_colmap, tmp_path, *model)
    _same_cameras(native_loader.read_cameras_binary(tmp_path / "cameras.bin"),
                  jax_colmap.read_cameras_binary(tmp_path / "cameras.bin"))
    _same_images(native_loader.read_images_binary(tmp_path / "images.bin"),
                 jax_colmap.read_images_binary(tmp_path / "images.bin"))
    for got, want in zip(native_loader.read_points3d_binary(tmp_path / "points3D.bin"),
                         jax_colmap.read_points3d_binary(tmp_path / "points3D.bin")):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("model_id", sorted(colmap.CAMERA_MODELS))
def test_intrinsics_and_qvec2rotmat_match_jax(model_id, rng):
    """Every camera model's (fx, fy, cx, cy), and the rotation of a random
    quaternion, equal to JAX's (np.array_equal)."""
    name, n_params = colmap.CAMERA_MODELS[model_id]
    assert jax_colmap.CAMERA_MODELS[model_id] == (name, n_params)
    params = rng.uniform(1, 100, size=n_params)
    got = colmap.ColmapCamera(1, name, 64, 48, params).intrinsics
    want = jax_colmap.ColmapCamera(1, name, 64, 48, params).intrinsics
    assert got == want
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    assert np.array_equal(colmap.qvec2rotmat(q), jax_colmap.qvec2rotmat(q))


def test_corrupt_files_rejected(tmp_path):
    """Bogus counts and truncated records fail cleanly in every native
    reader, as tests/test_native_loader.py holds the JAX loader."""
    cases = (("points3D.bin", native_loader.read_points3d_binary, 5, 20),
             ("images.bin", native_loader.read_images_binary, 3, 30),
             ("cameras.bin", native_loader.read_cameras_binary, 2, 20))
    for name, read, count, pad in cases:
        p = tmp_path / name
        p.write_bytes((1 << 50).to_bytes(8, "little"))  # absurd count, no records
        with pytest.raises(IOError):
            read(p)
        p.write_bytes(count.to_bytes(8, "little") + b"\x00" * pad)  # truncated mid-record
        with pytest.raises(IOError):
            read(p)


def test_stale_library_is_rebuilt_not_loaded(tmp_path, monkeypatch):
    """A library older than a source is not fresh; build() replaces it with
    a loadable one (through a temporary name and os.replace), and a fresh
    one is left alone."""
    lib = tmp_path / native_loader.LIB_NAME
    lib.write_bytes(b"not a real library")
    os.utime(lib, (0, 0))
    assert not native_loader.fresh(lib)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    assert native_loader.build() == lib
    assert native_loader.fresh(lib) and lib.read_bytes()[:4] == b"\x7fELF"
    assert not list(tmp_path.glob("*.tmp"))
    mtime = lib.stat().st_mtime_ns
    native_loader.build()
    assert lib.stat().st_mtime_ns == mtime


def test_failed_build_warns_and_falls_back_to_python_readers(tmp_path, rng, monkeypatch):
    """use_native=None: a library that does not build gives a warning that
    names the reason, and the pure-Python readers load the scene."""
    model = _model(rng, n_imgs=2)
    _write(colmap, tmp_path / "sparse" / "0", *model)

    def broken():
        raise native_loader.NativeBuildError("g++: not found (planted)")

    monkeypatch.setattr(native_loader, "library", broken)
    with pytest.warns(UserWarning, match="planted"):
        ds = load_colmap_dataset(tmp_path, load_images=False, cache_points=False, device="cpu")
    assert len(ds) == 2 and len(ds.gs) == 200


def test_build_error_names_a_missing_source(tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_loader, "SOURCES", (Path(tmp_path / "gone.cc"),))
    with pytest.raises(native_loader.NativeBuildError, match="gone.cc"):
        native_loader.build()
