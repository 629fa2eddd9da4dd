"""PyTorch port: the web viewer's SceneRenderer against the JAX package's,
on tests/test_viewer_server.py's fixture (every render mode, overlay toggle
and cloud mode; info(); the device cache's keys and bound), the port's
overlay lines against PIL's, the HTTP endpoints through the real stack
(JPEG bodies, the default, byte-equal to the JAX module's PIL encode of the
frame; PNG bodies under fmt=png bit-equal to the frames), and the live
training monitor through the train CLI's --monitor-port (its /preview.jpg
equal to PIL's JPEG of its frame at quality 88). The JAX side renders on its tiled
backend, the port on its plain path, both on the CPU."""

import io
import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from easygaussiansplatting_tpu.data import example_gaussians as jax_example_gaussians
from easygaussiansplatting_tpu.data.synthetic import look_at_camera as jax_look_at_camera
from easygaussiansplatting_tpu.viewer.server import SceneRenderer as JaxSceneRenderer
from easygaussiansplatting_tpu.viewer.server import _encode
from easygaussiansplatting_tpu_torch.data import example_gaussians
from easygaussiansplatting_tpu_torch.data.image_io import decode_png
from easygaussiansplatting_tpu_torch.data.synthetic import look_at_camera
from easygaussiansplatting_tpu_torch.train import __main__ as train_cli
from easygaussiansplatting_tpu_torch.viewer import monitor, server
from easygaussiansplatting_tpu_torch.viewer.server import SceneRenderer, draw_line, serve

torch.set_num_threads(2)

VIEW = dict(azimuth=0.7, elevation=0.3, width=64, height=48)
# frames may differ by one level where the two renders (within 1e-4 of each
# other) straddle a level; on this fixture none does (measured: 0 of every
# frame's pixels), and at most this share may
LEVEL_SHARE_MAX = 0.01
# PIL's ImageDraw.line against draw_line over the overlay views below: the
# share of the union of their drawn pixels that only one of them draws
# (measured 0.2262: PIL truncates negative coordinates toward zero and
# builds its wide lines as polygons); the limit is under twice it
LINE_MISMATCH_MAX = 0.45
LINE_DIST_MAX = 1.5  # px from a drawn pixel's centre to its projected segment


def _fixture(pkg_gaussians, look_at):
    g = pkg_gaussians()
    gs = {k: g[k] for k in ("pws", "rots", "scales", "alphas", "shs")}
    cams = [look_at(p, np.zeros(3), 64, 48, 60.0, cam_id=i)
            for i, p in enumerate(np.array([[0.8, 0.2, 0.3], [0.2, 0.8, 0.3],
                                            [-0.5, 0.5, 0.4]]))]
    cloud = {
        "pws": gs["pws"],
        "rots": gs["rots"],
        "scales": np.full_like(np.asarray(gs["scales"], np.float32), 0.01),
        "alphas": np.ones(len(gs["pws"]), np.float32) * 0.9,
        "shs": np.asarray(gs["shs"], np.float32)[:, :3],
    }
    return gs, cams, cloud


@pytest.fixture(scope="module")
def renderers():
    gs, cams, cloud = _fixture(example_gaussians, look_at_camera)
    port = SceneRenderer(gs, dataset_cameras=cams, cloud=cloud, marker_skip=1, device="cpu")
    gs, cams, cloud = _fixture(jax_example_gaussians, jax_look_at_camera)
    return port, JaxSceneRenderer(gs, dataset_cameras=cams, cloud=cloud, marker_skip=1)


@pytest.fixture(scope="module")
def server_url(renderers):
    started = []
    t = threading.Thread(target=serve, args=(renderers[0],),
                         kwargs=dict(port=0, on_ready=started.append), daemon=True)
    t.start()
    for _ in range(200):
        if started:
            break
        threading.Event().wait(0.05)
    httpd = started[0]
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _level_share(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 1, d.max()
    return float((d > 0).mean())


@pytest.mark.parametrize("mode", ["normal", "ball", "inverse"])
@pytest.mark.parametrize("markers,cloud", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_frames_match_jax(renderers, mode, markers, cloud):
    port, jax_ = renderers
    got = port.render(mode=mode, markers=markers, cloud=cloud, **VIEW)
    want = jax_.render(mode=mode, markers=markers, cloud=cloud, **VIEW)
    assert got.shape == (48, 64, 3) and got.dtype == np.uint8 and got.max() > 0
    assert _level_share(got, want) <= LEVEL_SHARE_MAX


@pytest.mark.parametrize("cloud_mode", ["rgb", "flat", "intensity", "rainbow"])
def test_cloud_modes_match_jax(renderers, cloud_mode):
    port, jax_ = renderers
    got = port.render(cloud=True, cloud_mode=cloud_mode, **VIEW)
    want = jax_.render(cloud=True, cloud_mode=cloud_mode, **VIEW)
    assert _level_share(got, want) <= LEVEL_SHARE_MAX
    if cloud_mode != "rgb":
        assert not np.array_equal(got, port.render(cloud=True, **VIEW))


@pytest.mark.parametrize("lores", [False, True])
def test_lores_matches_jax(renderers, lores):
    port, jax_ = renderers
    kw = dict(azimuth=0.9, elevation=0.2, width=256, height=192, lores=lores)
    got, want = port.render(**kw), jax_.render(**kw)
    assert got.shape == ((48, 64, 3) if lores else (192, 256, 3))
    assert _level_share(got, want) <= LEVEL_SHARE_MAX


def test_info_matches_jax(renderers):
    port, jax_ = renderers
    assert port.info() == jax_.info()
    assert port.info()["backend"] == "tiled"


def test_device_cache_keys_and_lru_bound_match_jax(renderers):
    port, jax_ = renderers
    port._dev_cache.clear()  # the fixture's earlier frames filled both differently
    jax_._dev_cache.clear()
    calls = [dict(markers=False, cloud=False, cloud_mode="rgb", mode="normal"),
             dict(markers=False, cloud=False, cloud_mode="flat", mode="normal"),  # no cloud
             dict(markers=True, cloud=True, cloud_mode="rainbow", mode="ball")]
    calls += [dict(markers=m, cloud=c, cloud_mode=cm, mode=md)
              for md in ("normal", "ball", "inverse") for m in (False, True)
              for c, cm in ((False, "rgb"), (True, "intensity"))]
    for kw in calls:
        a = port._device_params(**kw)
        jax_._device_params(**kw)
        assert list(port._dev_cache) == list(jax_._dev_cache), kw
        assert len(port._dev_cache) <= SceneRenderer.DEV_CACHE_MAX
        assert port._device_params(**kw) is a  # a hit uploads nothing: the same tensors
        jax_._device_params(**kw)
    assert len(port._dev_cache) == SceneRenderer.DEV_CACHE_MAX
    for bad in (dict(mode="wire"), dict(cloud_mode="hsv")):
        kw = {**calls[0], **bad}
        with pytest.raises(ValueError):
            port._device_params(**kw)


def test_cache_key_normalised_without_overlay_blocks():
    g = example_gaussians()
    r = SceneRenderer({k: g[k] for k in ("pws", "rots", "scales", "alphas", "shs")},
                      device="cpu")
    a = r._device_params(markers=True, cloud=True, cloud_mode="rainbow", mode="normal")
    assert r._device_params(markers=False, cloud=False, cloud_mode="rgb", mode="normal") is a
    assert list(r._dev_cache) == [(False, False, "rgb", "normal")]


def _segment_dist(xs, ys, p0, p1):
    """Distance from each pixel's centre to the segment p0 -> p1."""
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    d = p1 - p0
    c = np.stack([xs + 0.5, ys + 0.5], 1)
    t = np.clip((c - p0) @ d / (d @ d), 0.0, 1.0)
    return np.linalg.norm(c - (p0 + t[:, None] * d), axis=1)


def _project(cam, p):
    q = np.asarray(cam.Rcw, np.float64) @ np.asarray(p, np.float64) + np.asarray(cam.tcw,
                                                                               np.float64)
    return q[2], (q[0] * float(cam.fx) / q[2] + float(cam.cx),
                  q[1] * float(cam.fy) / q[2] + float(cam.cy))


def test_overlay_lines_against_pil(renderers):
    """Axes and grid drawn on a blank frame over 78 views, by the port and
    by the JAX module (PIL): the mismatch of the drawn-pixel sets stays
    under LINE_MISMATCH_MAX, and every pixel that one segment of the port
    draws lies within LINE_DIST_MAX of that segment's projection."""
    port, jax_ = renderers
    diff = union = 0
    for az in np.linspace(0.0, 6.0, 13):
        for el in (0.3, 0.9, -0.2):
            for w, h in ((64, 48), (256, 192)):
                cam = port.camera(azimuth=az, elevation=el, width=w, height=h)
                for axes, grid in ((True, False), (False, True)):
                    blank = np.zeros((h, w, 3), np.uint8)
                    a = jax_._draw_overlays(blank, cam, axes=axes, grid=grid).any(-1)
                    b = port._draw_overlays(blank, cam, axes=axes, grid=grid).any(-1)
                    assert not blank.any()  # drawn on a copy
                    diff += int((a ^ b).sum())
                    union += int((a | b).sum())
                for p0, p1, color, width in port.overlay_segments(axes=True, grid=True):
                    (za, ua), (zb, ub) = _project(cam, p0), _project(cam, p1)
                    if za < 0.2 or zb < 0.2:
                        continue
                    img = np.zeros((h, w, 3), np.uint8)
                    draw_line(img, ua, ub, color, width)
                    ys, xs = np.nonzero(img.any(-1))
                    if len(xs):
                        assert _segment_dist(xs, ys, ua, ub).max() <= LINE_DIST_MAX
    assert union > 1000
    assert diff / union <= LINE_MISMATCH_MAX, diff / union


def test_overlays_change_the_frame(renderers):
    port, _ = renderers
    plain = port.render(**VIEW)
    for kw in (dict(axes=True), dict(grid=True)):
        assert not np.array_equal(plain, port.render(**VIEW, **kw))


@pytest.mark.parametrize("width", [1, 2, 3])
def test_draw_line_far_endpoints_and_points(width):
    img = np.zeros((20, 30, 3), np.uint8)
    draw_line(img, (-1e7, 10.2), (1e7, 10.2), (9, 9, 9), width)
    assert img[10].all() and img[:, :, 0].sum() >= 30 * 9
    dot = np.zeros((5, 5, 3), np.uint8)
    draw_line(dot, (2.5, 2.5), (2.5, 2.5), (1, 2, 3), width)
    assert (dot[2, 2] == (1, 2, 3)).all()
    off = np.zeros((5, 5, 3), np.uint8)
    draw_line(off, (-9.0, -9.0), (-3.0, 40.0), (1, 2, 3), width)
    assert not off.any()


def test_http_index_and_info(server_url, renderers):
    status, ctype, body = _get(server_url + "/")
    assert status == 200 and "text/html" in ctype
    assert b"render mode" in body and b"/render?" in body and b"fmt=" not in body  # JPEG
    status, ctype, body = _get(server_url + "/info")
    assert status == 200 and ctype == "application/json"
    assert json.loads(body) == json.loads(json.dumps(renderers[0].info()))


QUERIES = [
    ("az=0.7&el=0.3&w=96&h=64", dict(azimuth=0.7, elevation=0.3, width=96, height=64), (96, 64)),
    ("az=0.7&el=0.3&w=256&h=192&lores=1&mode=inverse&markers=1&axes=1",
     dict(azimuth=0.7, elevation=0.3, width=256, height=192, lores=True, mode="inverse",
          markers=True, axes=True), (64, 48)),
    ("az=1.1&el=0.2&w=80&h=60&cloud=1&cloud_mode=rainbow&grid=1&r=3.0&cx=0.1&cy=0&cz=0.2",
     dict(azimuth=1.1, elevation=0.2, width=80, height=60, cloud=True, cloud_mode="rainbow",
          grid=True, radius=3.0, center=[0.1, 0.0, 0.2]), (80, 60)),
]


@pytest.mark.parametrize("fmt", ["&fmt=png", "&fmt=gif"])
@pytest.mark.parametrize("query,kw,size", QUERIES)
def test_http_render_png_bit_equal_to_the_frame(server_url, renderers, query, kw, size, fmt):
    """A fmt other than jpeg answers PNG, as the JAX module's _encode does."""
    status, ctype, body = _get(server_url + "/render?" + query + fmt)
    assert status == 200 and ctype == "image/png"
    want = renderers[0].render(**kw)
    im = Image.open(io.BytesIO(body))
    assert im.size == size and im.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(im), want)
    pixels, mode = decode_png(body)
    assert mode == "RGB"
    np.testing.assert_array_equal(pixels, want)


@pytest.mark.parametrize("fmt", ["", "&fmt=jpeg"])
@pytest.mark.parametrize("query,kw,size", QUERIES)
def test_http_render_jpeg_equal_to_the_jax_encode(server_url, renderers, query, kw, size, fmt,
                                                  monkeypatch):
    """No fmt, or fmt=jpeg: image/jpeg whose bytes are the JAX module's
    _encode (PIL at quality 90) of the frame the server rendered, which
    equals the frame render() gives."""
    port = renderers[0]
    served = []
    render_device = port.render_device
    monkeypatch.setattr(port, "render_device",
                        lambda **view: served.append(render_device(**view)) or served[-1])
    status, ctype, body = _get(server_url + "/render?" + query + fmt)
    assert status == 200 and ctype == "image/jpeg"
    assert len(served) == 1
    frame = served[0].numpy()
    assert frame.shape == (size[1], size[0], 3)
    np.testing.assert_array_equal(frame, port.render(**kw))
    assert body == _encode(frame, "jpeg", 90)[0]


@pytest.mark.parametrize("query,code", [("/render?mode=wire", 400),
                                        ("/render?cloud_mode=hsv", 400), ("/nope", 404)])
def test_http_errors(server_url, query, code):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server_url + query)
    assert ei.value.code == code


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_training_monitor_live_through_the_train_cli(tmp_path, monkeypatch):
    """The train CLI with --monitor-port for 2 epochs: after each epoch the
    monitor, asked over HTTP while training runs, serves that epoch's
    history and a frame of camera 0 as a JPEG at /preview.jpg: PIL's bytes at
    quality 88 of the frame epoch_cb rendered (recorded); the page asks for
    the JPEG."""
    seen, frames = [], []
    frame_u8 = monitor.frame_u8
    monkeypatch.setattr(monitor, "frame_u8",
                        lambda img: frames.append(frame_u8(img)) or frames[-1])

    class Probe(train_cli.TrainingMonitor):
        def epoch_cb(self, epoch, pool, **kw):
            super().epoch_cb(epoch, pool, **kw)
            url = f"http://127.0.0.1:{self.port}"
            seen.append((json.loads(_get(url + "/history")[2]), _get(url + "/preview.jpg"),
                         _get(url + "/")[2]))

    monkeypatch.setattr(train_cli, "TrainingMonitor", Probe)
    port = _free_port()
    history = train_cli.main(["--synthetic", "--epochs", "2", "--device", "cpu", "--out",
                              str(tmp_path), "--monitor-port", str(port), "--eval-every", "1"])
    assert len(seen) == 2 and len(frames) == 2
    for e, ((h, jpg, page), frame) in enumerate(zip(seen, frames), start=1):
        assert h["epoch"] == e and len(h["loss"]) == e and len(h["psnr"]) == e
        assert h["loss"] == pytest.approx(history["loss"][:e])
        assert frame.shape == (96, 128, 3) and frame.dtype == torch.uint8
        status, ctype, body = jpg
        assert status == 200 and ctype == "image/jpeg"
        buf = io.BytesIO()
        Image.fromarray(frame.numpy()).save(buf, format="JPEG", quality=88)
        assert body == buf.getvalue()
        assert b"training monitor" in page and b"/preview.jpg" in page
    with pytest.raises(urllib.error.URLError):  # closed with the run
        _get(f"http://127.0.0.1:{port}/history")


def test_monitor_before_the_first_epoch(tmp_path):
    from easygaussiansplatting_tpu_torch.train.config import TrainConfig
    from easygaussiansplatting_tpu_torch.viewer.monitor import TrainingMonitor

    cam = look_at_camera((3.0, 0.0, 1.0), np.zeros(3), 32, 24, 30.0)
    mon = TrainingMonitor(cam, TrainConfig(), port=0, log_fn=lambda *_: None)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"http://127.0.0.1:{mon.port}/preview.jpg")
        assert ei.value.code == 404
        h = json.loads(_get(f"http://127.0.0.1:{mon.port}/history")[2])
        assert h == {"epoch": 0, "loss": [], "psnr": [], "n_alive": []}
    finally:
        mon.close()


def test_serve_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = example_gaussians()
    with pytest.raises(RuntimeError, match="cuda"):
        server.SceneRenderer({k: g[k] for k in ("pws", "rots", "scales", "alphas", "shs")})
