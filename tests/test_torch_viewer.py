"""PyTorch port: the headless viewer against the JAX package. Orbit cameras
equal, turntable frames within the render tolerance (the JAX side on its
tiled backend), rainbow_sh and the rotation transforms bit-equal, camera
markers and frusta within 1e-6; the port's GIF read back by PIL; the
gaussian_viewer CLI's GIF, PNG frames and --serve; and no new module
imports jax or the JAX package."""

import io
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from easygaussiansplatting_tpu.data import example_gaussians as jax_example_gaussians
from easygaussiansplatting_tpu.data import gau_io as jax_gau_io
from easygaussiansplatting_tpu.data.synthetic import make_synthetic_scene as jax_scene
from easygaussiansplatting_tpu.utils.image import rainbow_sh as jax_rainbow_sh
from easygaussiansplatting_tpu.viewer import headless as jax_headless
from easygaussiansplatting_tpu_torch.data import example_gaussians
from easygaussiansplatting_tpu_torch.data import gau_io
from easygaussiansplatting_tpu_torch.data.image_io import decode_png
from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene
from easygaussiansplatting_tpu_torch.utils import gif
from easygaussiansplatting_tpu_torch.utils.image import rainbow_sh
from easygaussiansplatting_tpu_torch.viewer import headless

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
RENDER_ATOL = 1e-4  # the render's tolerance against JAX (tests/test_torch_render.py)
CAMERA_FIELDS = ("Rcw", "tcw", "fx", "fy", "cx", "cy", "width", "height", "id")


def _fixture_arrays(g):
    return {k: g[k] for k in ("pws", "rots", "scales", "alphas", "shs")}


def _random_rotations(rng, n=64):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


@pytest.mark.parametrize("kw", [dict(), dict(elevation=-0.2, f=70.0, up=(0.0, 1.0, 0.0))])
def test_orbit_cameras_equal_jax(kw):
    want = jax_headless.orbit_cameras((1.0, 2.0, 0.5), 4.0, n_frames=7, width=64, height=48, **kw)
    got = headless.orbit_cameras((1.0, 2.0, 0.5), 4.0, n_frames=7, width=64, height=48, **kw)
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        for f in CAMERA_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), f)


def test_render_turntable_matches_jax_frame_by_frame():
    g = _fixture_arrays(example_gaussians())
    want = jax_headless.render_turntable(_fixture_arrays(jax_example_gaussians()),
                                         backend="tiled", max_patches=2**10, n_frames=3,
                                         width=32, height=32)
    got = headless.render_turntable(g, backend="tiled", max_patches=2**10, n_frames=3, width=32,
                                    height=32, device="cpu")
    assert len(got) == 3
    assert any(np.abs(f).max() > 0 for f in got)
    for a, b in zip(got, want):
        assert a.shape == (3, 32, 32)
        np.testing.assert_allclose(a, np.asarray(b), atol=RENDER_ATOL)


def test_render_turntable_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        headless.render_turntable(_fixture_arrays(example_gaussians()), n_frames=1, width=16,
                                  height=16)


def test_rainbow_sh_bit_equal(rng):
    s = np.concatenate([rng.normal(size=500) * 100 + 120, [0.0, 127.5, 255.0, -10.0, 300.0]])
    for lo, hi in ((0.0, 255.0), (float(s.min()), float(s.max()) + 1e-6)):
        np.testing.assert_array_equal(rainbow_sh(s, lo, hi), jax_rainbow_sh(s, lo, hi))


def test_rotation_transforms_bit_equal(rng):
    q = _random_rotations(rng)
    R = jax_gau_io.quaternion_to_matrix(q)
    np.testing.assert_array_equal(gau_io.quaternion_to_matrix(q), R)
    np.testing.assert_array_equal(gau_io.matrix_to_quaternion(R),
                                  jax_gau_io.matrix_to_quaternion(R))
    g = example_gaussians()
    gs = gau_io.arrays_to_recarray(g["pws"], _random_rotations(rng, 4), g["scales"],
                                   g["alphas"], g["shs"])
    T = gau_io.quaternion_to_matrix(_random_rotations(rng, 1))[0]
    got, want = gau_io.rotate_gaussians(T, gs), jax_gau_io.rotate_gaussians(T, gs)
    for name in gs.dtype.names:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert not np.array_equal(got["pw"], gs["pw"])


def test_camera_markers_and_frusta_match_jax(rng):
    cams = make_synthetic_scene(seed=1, n_cams=6, n_gaussians=8)["cameras"]
    jcams = jax_scene(seed=1, n_cams=6, n_gaussians=8)["cameras"]
    for a, b in ((headless.camera_markers(cams[::2]), jax_headless.camera_markers(jcams[::2])),
                 (headless.camera_markers(cams, 0.05, (0.2, 0.4, 0.9)),
                  jax_headless.camera_markers(jcams, 0.05, (0.2, 0.4, 0.9)))):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=k)
    imgs = [rng.random((3, 48, 64)).astype(np.float32), None, rng.random((3, 20, 30))]
    got = headless.camera_frusta(cams[:3], images=imgs, tex_wh=(8, 6))
    want = jax_headless.camera_frusta(jcams[:3], images=imgs, tex_wh=(8, 6))
    assert len(got["pws"]) == 3 * 8 + 2 * 48
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def _gif_frames(data):
    im = Image.open(io.BytesIO(data))
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")).astype(np.float64))
    return im, frames


@pytest.mark.parametrize("fps", [20, 30])
def test_gif_read_back_by_pil(rng, tmp_path, fps):
    """Noise frames (the LZW table fills and clears) and a flat one, written
    by save_gif and read by PIL: count, size, duration, loop 0, and each
    pixel within 26 levels of its float value (half the palette's step of
    51 levels)."""
    frames = [rng.random((3, 72, 90)).astype(np.float32) * 1.2 - 0.1 for _ in range(3)]
    frames.append(np.full((3, 72, 90), 0.5, np.float32))
    path = tmp_path / "orbit.gif"
    headless.save_gif(path, frames, fps=fps)
    im, got = _gif_frames(path.read_bytes())
    assert im.n_frames == 4 and im.size == (90, 72)
    assert im.info["loop"] == 0 and im.info["duration"] == int(1000 / fps) // 10 * 10
    for f, g in zip(frames, got):
        want = np.transpose(np.clip(f, 0, 1), (1, 2, 0)) * 255.0
        assert np.abs(g - want).max() <= 26.0


def test_gif_palette_and_header():
    data = gif.encode_gif([np.zeros((3, 5, 7), np.float32)], fps=10)
    assert data[:6] == b"GIF89a" and data[-1:] == b"\x3b"
    assert data[6:10] == bytes([7, 0, 5, 0])
    pal = gif.palette()
    assert len({tuple(c) for c in pal[:252]}) == 252
    assert b"NETSCAPE2.0\x03\x01\x00\x00\x00" in data
    with pytest.raises(ValueError):
        gif.encode_gif([])


def test_gaussian_viewer_cli_writes_gif_and_frames(tmp_path):
    out = tmp_path / "orbit.gif"
    res = subprocess.run(
        [sys.executable, "-m", "easygaussiansplatting_tpu_torch.gaussian_viewer", "--device",
         "cpu", "--frames", "2", "--width", "32", "--height", "24", "--mode", "ball", "--out",
         str(out), "--save-frames", str(tmp_path / "f")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "wrote" in res.stdout
    im, frames = _gif_frames(out.read_bytes())
    assert im.n_frames == 2 and im.size == (32, 24)
    for i in range(2):
        pixels, mode = decode_png((tmp_path / f"f{i:04d}.png").read_bytes())
        assert mode == "RGB" and pixels.shape == (24, 32, 3)
        assert np.abs(pixels.astype(np.float64) - frames[i]).max() <= 26.0


def test_gaussian_viewer_cli_serves(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "easygaussiansplatting_tpu_torch.gaussian_viewer", "--device",
         "cpu", "--serve", "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("viewer: http://127.0.0.1:"), line + proc.stderr.read()
        url = line.split()[1].rstrip("/")
        with urllib.request.urlopen(url + "/render?az=0.5&w=64&h=48&fmt=png", timeout=60) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "image/png"
            pixels, _ = decode_png(r.read())
        assert pixels.shape == (48, 64, 3) and pixels.max() > 0
        # no fmt: a JPEG of the same view, as the JAX viewer answers (its
        # bytes against PIL's are tests/test_torch_viewer_server.py's)
        with urllib.request.urlopen(url + "/render?az=0.5&w=64&h=48", timeout=60) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "image/jpeg"
            decoded = np.asarray(Image.open(io.BytesIO(r.read())).convert("RGB"))
        assert decoded.shape == (48, 64, 3)
        assert np.abs(decoded.astype(np.int32) - pixels.astype(np.int32)).mean() < 4
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


NEW_MODULES = ("bench_scene", "viewer_fps", "gaussian_viewer", "sh_demo", "viewer",
               "viewer.headless", "viewer.server", "viewer.monitor", "utils.gif", "utils.image",
               "data.gau_io", "train.__main__")


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {NEW_MODULES!r}:\n"
        "    importlib.import_module('easygaussiansplatting_tpu_torch.' + m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'easygaussiansplatting_tpu'\n"
        "             or k.startswith('easygaussiansplatting_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'PIL' not in sys.modules\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
