"""PyTorch port: the SH demo against the repository's root sh_demo.py (JAX).
The fit within 1e-4 of JAX's coefficients at degree 5, the sphere strip
within 1e-5 of JAX's, --image read bit-equal to JAX's PIL path (the port's
decoders and Pillow-exact resize), the CLI's grid, and the served frames
(JPEGs equal to PIL's of the strip)."""

import io
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from easygaussiansplatting_tpu_torch import sh_demo
from easygaussiansplatting_tpu_torch.data.image_io import decode_png
from easygaussiansplatting_tpu_torch.data.make_io_fixtures import FIXTURES

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import sh_demo as jax_sh_demo  # noqa: E402  (the root JAX CLI)

torch.set_num_threads(2)

FIT_ATOL = 1e-4
STRIP_ATOL = 1e-5


class _Stop(Exception):
    pass


def test_sphere_dirs_and_texture_equal_jax():
    for a, b in zip(sh_demo.sphere_dirs(8, 16), jax_sh_demo.sphere_dirs(8, 16)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sh_demo.procedural_texture(32, 64),
                                  jax_sh_demo.procedural_texture(32, 64))


@pytest.fixture(scope="module")
def fits():
    img = sh_demo.procedural_texture(32, 64)
    return img, sh_demo.fit_sh(img, 5, device="cpu"), jax_sh_demo.fit_sh(img, 5)


def test_fit_sh_matches_jax_at_degree_5(fits):
    _, (coeffs, basis), (jcoeffs, jbasis) = fits
    assert coeffs.shape == (36, 3) and coeffs.dtype == np.float32
    np.testing.assert_array_equal(basis, jbasis)
    np.testing.assert_allclose(coeffs, np.asarray(jcoeffs), atol=FIT_ATOL)


def test_reconstruct_error_falls_with_degree(fits):
    img, (coeffs, basis), _ = fits
    errs = [np.abs(sh_demo.reconstruct(basis, coeffs, d, 32, 64) - img).mean()
            for d in range(6)]
    assert errs[-1] < errs[0]


@pytest.mark.parametrize("angle", [0.0, 1.0, -2.5])
def test_sphere_strip_matches_jax(fits, angle):
    img, (coeffs, _), (jcoeffs, _) = fits
    got = sh_demo.make_sphere_renderer(img, coeffs, res=48, device="cpu")(angle).numpy()
    want = np.asarray(jax_sh_demo.make_sphere_renderer(img, np.asarray(jcoeffs), res=48)(angle))
    assert got.shape == (48, 48 * 5, 3)
    np.testing.assert_allclose(got, want, atol=STRIP_ATOL)
    np.testing.assert_allclose(got[0, 0], 0.08, atol=1e-6)  # a corner: background


@pytest.mark.parametrize("name", ["png_RGB.png", "png_RGBA.png", "png_L.png", "png_LA.png",
                                  "png_P.png", "jpeg_420.jpg"])
def test_image_texture_bit_equal_to_jax_pil_path(monkeypatch, name):
    """The JAX CLI's --image texture (PIL: convert RGB, resize, / 255),
    recorded at its fit_sh call, against the port's load_texture."""
    seen = {}

    def record(img, degree):
        seen["img"] = img
        raise _Stop

    monkeypatch.setattr(jax_sh_demo, "fit_sh", record)
    monkeypatch.setattr(sys, "argv", ["sh_demo.py", "--image", str(FIXTURES / name),
                                      "--height", "24"])
    with pytest.raises(_Stop):
        jax_sh_demo.main()
    got = sh_demo.load_texture(FIXTURES / name, 48, 24, device="cpu")
    assert got.shape == (24, 48, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, seen["img"])


def test_cli_writes_its_grid(tmp_path, capsys):
    out = tmp_path / "sh.png"
    sh_demo.main(["--height", "32", "--degree", "2", "--out", str(out), "--device", "cpu"])
    assert f"wrote {out}" in capsys.readouterr().out
    grid, mode = decode_png(out.read_bytes())
    assert mode == "RGB" and grid.shape == (32 * 4, 64, 3)
    img = sh_demo.procedural_texture(32, 64)
    np.testing.assert_array_equal(grid[:32], (img * 255).astype(np.uint8))


def test_served_frames_are_pngs_of_the_strip(fits, monkeypatch):
    """/frame answers a JPEG of the strip, as the JAX demo does: the bytes of
    PIL's save at quality 90 of its (frame * 255) cast to uint8, where the
    strip is the one the server rendered (recorded) and equal, cast, to a
    fresh render of the same angle."""
    img, (coeffs, _), _ = fits
    served = []
    make = sh_demo.make_sphere_renderer

    def recording(*args, **kw):
        render = make(*args, **kw)
        return lambda angle: served.append(render(angle)) or served[-1]

    monkeypatch.setattr(sh_demo, "make_sphere_renderer", recording)
    started = []
    t = threading.Thread(target=sh_demo.serve_spheres, args=(img, coeffs),
                         kwargs=dict(port=0, device="cpu", on_ready=started.append),
                         daemon=True)
    t.start()
    for _ in range(200):
        if started:
            break
        threading.Event().wait(0.05)
    httpd = started[0]
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(url + "/frame?angle=0.5", timeout=60) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "image/jpeg"
            body = r.read()
        want = make(img, coeffs, device="cpu")(0.5).numpy()
        assert len(served) == 1
        frame = (served[0].numpy() * 255).astype(np.uint8)
        np.testing.assert_array_equal(frame, (want * 255).astype(np.uint8))
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="JPEG", quality=90)
        assert body == buf.getvalue()
        assert Image.open(io.BytesIO(body)).size == (want.shape[1], want.shape[0])
        with urllib.request.urlopen(url + "/", timeout=60) as r:
            assert b"SH demo" in r.read()
    finally:
        httpd.shutdown()
        t.join(timeout=30)
    assert not t.is_alive()
