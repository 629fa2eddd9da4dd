"""Interactive web viewer: frames rendered on the card, streamed to a browser.

Port of easygaussiansplatting_tpu/viewer/server.py (``SceneRenderer``,
``make_handler``, ``serve``) with its page, ``viewer/index.html``: the full
splatting renderer runs server-side and the browser is a thin canvas; mouse
orbit, pan and zoom ask ``/render`` for a frame. Render modes normal, ball
and inverse; the dataset cameras as oriented, image-textured frusta
(``markers=1``); a point-cloud overlay (``cloud=1``) in the colour modes
rgb, flat, intensity and rainbow; world axes and a ground grid drawn on the
frame.

A frame goes out as JPEG (quality 90) unless ``fmt`` names another format,
then as PNG, as in the JAX module; the JPEG bytes are PIL's. On the card
the frame stays on the device up to its encode by K11
(``ops/kernels/jpeg.py``), so only the compressed bytes cross to the host.

Where the port differs from the JAX module:

* The axis and grid lines are drawn by :func:`draw_line`, the port's own
  numpy rasteriser, where the JAX module calls PIL's ``ImageDraw.line``; it
  is not pixel-equal to PIL's.
* No jit: each frame calls ``ops/rasterize.render`` (on the card K1, K3's
  three calls and K4 once; a JPEG adds K11 and K3's two calls), on
  parameters that stay on the device.
* With tracing on (``utils/trace.py``, off by default) each connection is a
  ``viewer.request`` span, from before its request line is read to its
  last byte, holding ``render`` (with ``render.wait`` for the lock,
  ``render.preprocess``, ``render.binning``, ``render.blend``) and
  ``encode.launch`` / ``encode.wait``, and binning's counters.
"""

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.data.gau_io import SH_C0
from easygaussiansplatting_tpu_torch.data.synthetic import look_at_camera
from easygaussiansplatting_tpu_torch.ops.kernels.jpeg import encode_jpeg
from easygaussiansplatting_tpu_torch.ops.rasterize import render, resolve_backend
from easygaussiansplatting_tpu_torch.utils import trace
from easygaussiansplatting_tpu_torch.utils.device import resolve_device
from easygaussiansplatting_tpu_torch.utils.image import encode_png, frame_u8, rainbow_sh
from easygaussiansplatting_tpu_torch.viewer.headless import camera_frusta

MODES = ("normal", "ball", "inverse")
CLOUD_MODES = ("rgb", "flat", "intensity", "rainbow")
PARAM_KEYS = ("pws", "shs", "alphas", "scales", "rots")


def draw_line(img, p0, p1, color, width=1):
    """Draw the segment p0 -> p1 (pixel coordinates, x right, y down; pixel
    (i, j) covers [i, i+1) x [j, j+1), as in PIL) into the [H,W,3] uint8
    array ``img`` in place. Width 1: the pixels holding the endpoints,
    joined by one pixel a step along the major axis, the minor coordinate
    rounded half up (an integer DDA, as PIL's Bresenham line but for its
    ties and for PIL's truncation of negative coordinates toward zero).
    Wider: every pixel whose centre lies within width / 2 of the segment.
    A drawn pixel's centre lies within 1.25 px (width 1) or width / 2 of
    the segment; pixels outside the image are skipped, so far endpoints
    cost nothing."""
    h, w = img.shape[:2]
    if width <= 1:
        x0, y0, x1, y1 = (math.floor(float(v)) for v in (*p0, *p1))
        dx, dy = x1 - x0, y1 - y0
        major_x = abs(dx) >= abs(dy)
        a0, a1, b0, db, da, size = ((x0, x1, y0, dy, dx, w) if major_x
                                    else (y0, y1, x0, dx, dy, h))
        lo, hi = max(min(a0, a1), 0), min(max(a0, a1), size - 1)
        if hi < lo:
            return
        a = np.arange(lo, hi + 1)
        step = np.floor((a - a0) * db / da + 0.5) if da else np.zeros(len(a))
        b = b0 + step.astype(np.int64)
        xs, ys = (a, b) if major_x else (b, a)
    else:
        x0, y0, x1, y1 = (float(v) - 0.5 for v in (*p0, *p1))  # pixel centres on integers
        dx, dy = x1 - x0, y1 - y0
        r = width / 2.0
        xlo, xhi = max(math.floor(min(x0, x1) - r), 0), min(math.ceil(max(x0, x1) + r), w - 1)
        ylo, yhi = max(math.floor(min(y0, y1) - r), 0), min(math.ceil(max(y0, y1) + r), h - 1)
        if xhi < xlo or yhi < ylo:
            return
        gy, gx = np.mgrid[ylo:yhi + 1, xlo:xhi + 1]
        n2 = dx * dx + dy * dy
        t = np.clip(((gx - x0) * dx + (gy - y0) * dy) / n2, 0.0, 1.0) if n2 else 0.0
        near = (gx - (x0 + t * dx)) ** 2 + (gy - (y0 + t * dy)) ** 2 <= r * r
        xs, ys = gx[near], gy[near]
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


class SceneRenderer:
    """One scene rendered on one device; thread-safe (the card is one: a
    lock covers each frame's upload and render; what follows runs on the
    same stream, in order)."""

    LORES_DIV = 4  # drag-preview downscale
    DEV_CACHE_MAX = 8  # bound on device-resident parameter sets

    def __init__(self, gaussians, dataset_cameras=(), cloud=None, backend="auto",
                 max_patches=2**20, marker_skip=5, dataset_images=None, device="cuda"):
        self.lock = threading.Lock()
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.max_patches = max_patches

        a = {k: np.asarray(v, np.float32) for k, v in gaussians.items()}
        n = len(a["pws"])
        a["shs"] = a["shs"].reshape(n, -1)
        a["alphas"] = a["alphas"].reshape(n)
        self.sh_degree = int(np.sqrt(max(1, a["shs"].shape[1] // 3))) - 1

        # overlay blocks are appended once; toggles only zero their alphas
        self.blocks = [("scene", a)]
        self.dataset_cameras = list(dataset_cameras)
        if self.dataset_cameras:
            skip = max(1, marker_skip)
            cams_sel = self.dataset_cameras[::skip]
            imgs_sel = list(dataset_images)[::skip] if dataset_images is not None else None
            m = camera_frusta(cams_sel, images=imgs_sel)
            self.blocks.append(("markers", self._pad_sh(m, a["shs"].shape[1])))
        self._cloud_z = None
        if cloud is not None and len(cloud["pws"]):
            self.blocks.append(("cloud", self._pad_sh(cloud, a["shs"].shape[1])))
            self._cloud_z = np.asarray(cloud["pws"], np.float32)[:, 2]

        self.full = {
            k: np.concatenate([np.asarray(b[k], np.float32).reshape(len(b["pws"]), -1)
                               for _, b in self.blocks]).squeeze()
            for k in PARAM_KEYS
        }
        self.full["shs"] = self.full["shs"].reshape(len(self.full["pws"]), -1)
        self.slices = {}
        off = 0
        for name, b in self.blocks:
            self.slices[name] = slice(off, off + len(b["pws"]))
            off += len(b["pws"])

        pws = self.full["pws"]
        self.center = pws[self.slices["scene"]].mean(0).tolist()
        self.radius = 2.5 * float(np.percentile(
            np.linalg.norm(pws[self.slices["scene"]] - np.float32(self.center), axis=1), 90))
        self._dev_cache = {}  # appearance key -> device-resident params

    @staticmethod
    def _pad_sh(block, sh_width):
        b = {k: np.asarray(v, np.float32) for k, v in block.items()}
        sh = np.zeros((len(b["pws"]), sh_width), np.float32)
        sh[:, : b["shs"].shape[1]] = b["shs"].reshape(len(b["pws"]), -1)
        b["shs"] = sh
        return b

    def camera(self, *, azimuth=0.0, elevation=0.3, radius=None, center=None, width=640,
               height=480, fov_f=0.9, lores=False):
        """The orbit camera of a view (at 1/LORES_DIV of the size under
        ``lores``, with the same field of view)."""
        if lores:
            width = max(64, width // self.LORES_DIV)
            height = max(48, height // self.LORES_DIV)
        center = np.asarray(center if center is not None else self.center, np.float64)
        radius = float(radius or self.radius)
        pos = center + radius * np.array([
            np.cos(elevation) * np.cos(azimuth),
            np.cos(elevation) * np.sin(azimuth),
            np.sin(elevation),
        ])
        return look_at_camera(pos, center, width, height, fov_f * width, cam_id=0)

    def render(self, **view):
        """Render one view; returns [H,W,3] uint8 (the arguments are
        :meth:`render_device`'s).

        `lores`: render at 1/LORES_DIV resolution, the interactive-drag
        preview (the browser scales it back up; a full-resolution frame
        follows on mouse release). The camera is rebuilt from the same
        fov_f, so fx scales with width and the field of view is identical."""
        return self.render_device(**view).cpu().numpy()

    def render_device(self, *, azimuth=0.0, elevation=0.3, radius=None, center=None, width=640,
                      height=480, mode="normal", markers=False, cloud=False, axes=False,
                      grid=False, fov_f=0.9, cloud_mode="rgb", lores=False):
        """:meth:`render`'s frame as an [H,W,3] uint8 tensor on the
        renderer's device, for an encode there. The axis and grid lines are
        drawn on the host (:func:`draw_line`) and the drawn frame uploaded
        again."""
        with trace.span("render"):
            cam = self.camera(azimuth=azimuth, elevation=elevation, radius=radius,
                              center=center, width=width, height=height, fov_f=fov_f,
                              lores=lores)
            with trace.span("render.wait"):
                self.lock.acquire()
            try:  # one card: uploads and renders are serialised
                dev = self._device_params(markers=markers, cloud=cloud, cloud_mode=cloud_mode,
                                          mode=mode)
                img, _ = render(*dev, cam, backend=self.backend, max_patches=self.max_patches,
                                sh_degree=self.sh_degree, need_grads=False, device=self.device)
                with trace.span("render.blend"):
                    out = frame_u8(img)
            finally:
                self.lock.release()
            if axes or grid:
                drawn = self._draw_overlays(out.cpu().numpy(), cam, axes=axes, grid=grid)
                out = torch.from_numpy(drawn).to(self.device)
        return out

    def _device_params(self, *, markers, cloud, cloud_mode, mode):
        """Device-resident (pws, shs, alphas, scales, rots) per appearance.

        The per-frame mutations (overlay alpha toggles, cloud colour modes,
        ball and inverse render modes) depend only on these toggles, not on
        the camera, so each combination is built once and kept on the
        device; a cache hit uploads nothing.

        Keys are normalised so that toggles that cannot change the params
        never mint a new entry (markers or cloud without the matching
        block, cloud_mode with cloud off), and the cache is LRU-bounded at
        DEV_CACHE_MAX entries: raw HTTP query values must not grow device
        memory for the server's lifetime. Invalid mode / cloud_mode strings
        raise (HTTP 400 upstream)."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if cloud_mode not in CLOUD_MODES:
            raise ValueError(f"cloud_mode must be one of {CLOUD_MODES}, got {cloud_mode!r}")
        markers = bool(markers) and "markers" in self.slices
        cloud = bool(cloud) and "cloud" in self.slices
        if not cloud:
            cloud_mode = "rgb"
        key = (markers, cloud, cloud_mode, mode)
        if key in self._dev_cache:
            self._dev_cache[key] = self._dev_cache.pop(key)  # LRU touch
            return self._dev_cache[key]

        a = {k: v.copy() for k, v in self.full.items()}
        if not markers and "markers" in self.slices:
            a["alphas"][self.slices["markers"]] = 0.0
        if not cloud and "cloud" in self.slices:
            a["alphas"][self.slices["cloud"]] = 0.0
        elif cloud and "cloud" in self.slices and cloud_mode != "rgb":
            # the reference CloudItem's colour modes: flat single colour,
            # grey intensity, height rainbow
            cs = self.slices["cloud"]
            if cloud_mode == "flat":
                a["shs"][cs, :3] = (np.float32([0.95, 0.85, 0.25]) - 0.5) / SH_C0
            elif cloud_mode == "intensity":
                rgb = a["shs"][cs, :3] * SH_C0 + 0.5
                lum = (0.2126 * rgb[:, 0] + 0.7152 * rgb[:, 1] + 0.0722 * rgb[:, 2])[:, None]
                a["shs"][cs, :3] = (lum - 0.5) / SH_C0
            elif cloud_mode == "rainbow" and self._cloud_z is not None:
                z = self._cloud_z
                a["shs"][cs, :3] = rainbow_sh(z, float(z.min()), float(z.max()) + 1e-6)
        if mode == "ball":
            # hard opaque discs: saturate opacity, tighten the footprint
            s = self.slices["scene"]
            a["alphas"][s] = np.where(a["alphas"][s] > 0.0, 0.99, 0.0)
            a["scales"][s] = a["scales"][s] * 0.6
        elif mode == "inverse":
            # color = sum c.Y + 0.5, so negating the coefficients gives 1 - color
            s = self.slices["scene"]
            a["shs"][s] = -a["shs"][s]

        dev = tuple(torch.from_numpy(np.ascontiguousarray(a[k])).to(self.device)
                    for k in PARAM_KEYS)
        self._dev_cache[key] = dev
        while len(self._dev_cache) > self.DEV_CACHE_MAX:
            del self._dev_cache[next(iter(self._dev_cache))]
        return dev

    def _draw_overlays(self, img_u8, cam, *, axes=False, grid=False):
        """World-space axis and ground-grid lines, projected with the render
        camera and drawn on a copy of the frame by :func:`draw_line`."""
        img = img_u8.copy()
        R = np.asarray(cam.Rcw, np.float64)
        t = np.asarray(cam.tcw, np.float64)
        fx, fy = float(cam.fx), float(cam.fy)
        cx, cy = float(cam.cx), float(cam.cy)

        def draw(p0, p1, color, w=1):
            a = R @ np.asarray(p0, np.float64) + t
            b = R @ np.asarray(p1, np.float64) + t
            if a[2] < 0.2 or b[2] < 0.2:  # either end behind the camera
                return
            ua = (a[0] * fx / a[2] + cx, a[1] * fy / a[2] + cy)
            ub = (b[0] * fx / b[2] + cx, b[1] * fy / b[2] + cy)
            draw_line(img, ua, ub, color, w)

        for p0, p1, color, w in self.overlay_segments(axes=axes, grid=grid):
            draw(p0, p1, color, w)
        return img

    def overlay_segments(self, *, axes=False, grid=False):
        """The world-space overlay segments (p0, p1, colour, width): the
        ground grid's lines, then the +x, +y, +z axes."""
        s = max(1.0, round(self.radius / 2.5))
        segs = []
        if grid:
            for i in np.arange(-s, s + 0.5):
                segs.append(((i, -s, 0), (i, s, 0), (90, 90, 90), 1))
                segs.append(((-s, i, 0), (s, i, 0), (90, 90, 90), 1))
        if axes:
            segs.append(((0, 0, 0), (s, 0, 0), (235, 70, 70), 2))   # +x red
            segs.append(((0, 0, 0), (0, s, 0), (70, 235, 70), 2))   # +y green
            segs.append(((0, 0, 0), (0, 0, s), (90, 90, 245), 2))   # +z blue
        return segs

    def info(self):
        return {
            "n_gaussians": int(self.slices["scene"].stop),
            "n_dataset_cameras": len(self.dataset_cameras),
            "has_cloud": "cloud" in self.slices,
            "center": self.center,
            "radius": self.radius,
            "backend": self.backend,
            "sh_degree": self.sh_degree,
            "modes": list(MODES),
            "cloud_modes": list(CLOUD_MODES),
        }


def make_handler(renderer):
    index_html = (Path(__file__).parent / "index.html").read_text()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def handle(self):
            # from before the request line is read to the flushed last byte
            with trace.request("viewer.request"):
                super().handle()

        def _send(self, code, body, ctype):
            trace.note(status=code, bytes=len(body))
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[-1] for k, v in parse_qs(url.query).items()}
            trace.note(path=url.path)
            try:
                if url.path in ("/", "/index.html"):
                    self._send(200, index_html.encode(), "text/html")
                elif url.path == "/info":
                    self._send(200, json.dumps(renderer.info()).encode(), "application/json")
                elif url.path == "/render":
                    if q.get("mode", "normal") not in MODES or \
                            q.get("cloud_mode", "rgb") not in CLOUD_MODES:
                        self._send(400, b"bad mode/cloud_mode", "text/plain")
                        return
                    view = dict(
                        azimuth=float(q.get("az", 0.0)),
                        elevation=float(q.get("el", 0.3)),
                        radius=float(q["r"]) if "r" in q else None,
                        center=[float(q["cx"]), float(q["cy"]), float(q["cz"])]
                        if "cx" in q else None,
                        width=int(q.get("w", 640)),
                        height=int(q.get("h", 480)),
                        mode=q.get("mode", "normal"),
                        markers=q.get("markers", "0") == "1",
                        cloud=q.get("cloud", "0") == "1",
                        axes=q.get("axes", "0") == "1",
                        grid=q.get("grid", "0") == "1",
                        fov_f=float(q.get("fov", 0.9)),
                        cloud_mode=q.get("cloud_mode", "rgb"),
                        lores=q.get("lores", "0") == "1",
                    )
                    trace.note(lores=view["lores"], size=f"{view['width']}x{view['height']}")
                    if q.get("fmt", "jpeg") == "jpeg":
                        body = encode_jpeg(renderer.render_device(**view), quality=90)
                        self._send(200, body, "image/jpeg")
                    else:
                        self._send(200, encode_png(renderer.render(**view)), "image/png")
                else:
                    self._send(404, b"not found", "text/plain")
            except Exception as e:  # surface errors to the browser console
                self._send(500, f"{type(e).__name__}: {e}".encode(), "text/plain")

    return Handler


def serve(renderer, port=8080, host="127.0.0.1", on_ready=None):
    """Serve the viewer until interrupted (or until ``shutdown()`` of the
    server, which ``on_ready(server)`` receives once it listens; port 0
    takes a free port, printed with the address)."""
    httpd = ThreadingHTTPServer((host, port), make_handler(renderer))
    print(f"viewer: http://{host}:{httpd.server_address[1]}/  (ctrl-c to stop)", flush=True)
    if on_ready is not None:
        on_ready(httpd)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
