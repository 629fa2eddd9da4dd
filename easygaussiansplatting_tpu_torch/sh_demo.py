"""Spherical-harmonics fitting demo.

Port of the repository's root sh_demo.py (``sphere_dirs``,
``procedural_texture``, ``fit_sh``, ``reconstruct``,
``make_sphere_renderer``, ``serve_spheres``): fit real-SH coefficients
(degree <= 5, 36 basis functions x RGB) to a colour signal on the sphere
sampled from an equirectangular texture by one weighted least-squares solve,
C = (B^T W B)^-1 B^T W Y, then show the ground truth beside reconstructions
at increasing SH truncation degrees.

The solve runs in torch float32 on ``--device`` (TF32 off on the card); the
JAX function runs it outside any Pallas kernel, so no kernel of the port is
reached. ``--image`` is decoded by the port's data/image_io (PNG by its own
decoder, JPEG by nvJPEG on the card) and resized by its Pillow-exact resize:
no PIL on the card. The grid is a PNG; the served frames are JPEGs with
PIL's bytes, encoded on the card by K11 (ops/kernels/jpeg.py).

    python -m easygaussiansplatting_tpu_torch.sh_demo                      # PNG grid
    python -m easygaussiansplatting_tpu_torch.sh_demo --image earth.png
    python -m easygaussiansplatting_tpu_torch.sh_demo --serve              # rotating spheres
    python -m easygaussiansplatting_tpu_torch.sh_demo --device cpu --height 32

``--serve`` shows the five spheres (ground truth and degrees 1, 3, 4, 5)
rendered server-side as orthographic discs; the page rotates them, and a
drag scrubs.
"""

import argparse
import contextlib
import math
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.data.image_io import decode_file, pillow_resize, to_rgb
from easygaussiansplatting_tpu_torch.utils.device import resolve_device
from easygaussiansplatting_tpu_torch.ops.kernels.jpeg import encode_jpeg
from easygaussiansplatting_tpu_torch.utils.image import save_png
from easygaussiansplatting_tpu_torch.utils.sh import sh_basis


def sphere_dirs(h, w):
    """Unit directions for an equirectangular grid (lat-long)."""
    theta = (np.arange(h) + 0.5) / h * np.pi          # polar angle [0, pi]
    phi = (np.arange(w) + 0.5) / w * 2.0 * np.pi      # azimuth [0, 2pi)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    x = np.sin(t) * np.cos(p)
    y = np.sin(t) * np.sin(p)
    z = np.cos(t)
    return x, y, z, np.sin(t)  # sin(theta) = solid-angle weight


def procedural_texture(h, w):
    """A colourful smooth test signal on the sphere, [H,W,3] in [0, 1]."""
    x, y, z, _ = sphere_dirs(h, w)
    r = 0.5 + 0.45 * np.sin(3 * x + 2 * y) * np.cos(2 * z)
    g = 0.5 + 0.45 * np.cos(4 * y * z) * np.sin(x + z)
    b = 0.5 + 0.45 * np.sin(2 * (x + y + z))
    return np.stack([r, g, b], axis=-1).clip(0, 1)


def load_texture(path, width, height, device="cuda"):
    """An image file as an equirectangular texture [height, width, 3]
    float32: converted to RGB, resized as PIL's ``Image.resize`` resizes it,
    then / 255, as the JAX demo reads it through PIL."""
    img, mode = decode_file(path, device)
    rgb = pillow_resize(to_rgb(img, mode), "RGB", (width, height))
    return rgb.cpu().numpy().astype(np.float32) / 255.0


@contextlib.contextmanager
def _no_tf32():
    """Full float32 matmuls on the card (no TF32) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def fit_sh(img, degree, device="cuda"):
    """Weighted least-squares SH fit. img: [H,W,3]. Returns (coeffs [K,3]
    float32, the basis [H*W, K] float64)."""
    dev = resolve_device(device)
    h, w, _ = img.shape
    x, y, z, wgt = sphere_dirs(h, w)
    basis = np.stack(sh_basis(np, x.ravel(), y.ravel(), z.ravel(), degree), axis=1)  # [N,K]
    B = torch.as_tensor(basis, dtype=torch.float32, device=dev)
    Y = torch.as_tensor(np.asarray(img).reshape(-1, 3), dtype=torch.float32, device=dev)
    wv = torch.as_tensor(wgt.ravel(), dtype=torch.float32, device=dev)
    with _no_tf32():
        Bw = B * wv[:, None]
        coeffs = torch.linalg.solve(B.T @ Bw, Bw.T @ Y)
    return coeffs.cpu().numpy(), basis


def reconstruct(basis, coeffs, degree, h, w):
    k = (degree + 1) ** 2
    return (basis[:, :k] @ coeffs[:k]).reshape(h, w, 3)


def make_sphere_renderer(img, coeffs, degrees=(1, 3, 4, 5), res=192, device="cuda"):
    """angle -> [res, res*(1+len(degrees)), 3] float32 strip on ``device``:
    the ground-truth texture sphere and the SH reconstructions at each
    truncation degree, drawn as orthographic discs rotated about the
    vertical axis. ``coeffs`` holds 36 rows (degree 5; pad a lower fit)."""
    dev = resolve_device(device)
    h, w, _ = img.shape
    tex = torch.as_tensor(np.asarray(img), dtype=torch.float32, device=dev)
    cf = torch.as_tensor(np.asarray(coeffs), dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(torch.linspace(1, -1, res, device=dev),
                            torch.linspace(-1, 1, res, device=dev), indexing="ij")
    rr = uu * uu + vv * vv
    mask = rr <= 1.0
    zz = torch.sqrt(torch.clamp(1.0 - rr, min=0.0))  # toward the viewer

    def render(angle):
        ca, sa = math.cos(angle), math.sin(angle)
        # view dirs (x right, z up, y toward viewer) rotated about z
        x = ca * uu + sa * zz
        y = -sa * uu + ca * zz
        z = vv
        # ground truth: bilinear equirectangular lookup
        theta = torch.arccos(torch.clamp(z, -1, 1))
        phi = torch.remainder(torch.atan2(y, x), 2 * math.pi)
        fy = torch.clamp(theta / math.pi * h - 0.5, 0, h - 1)
        fx = phi / (2 * math.pi) * w - 0.5
        y0 = torch.floor(fy).long()
        x0 = torch.remainder(torch.floor(fx).long(), w)
        wy = (fy - y0)[..., None]
        wx = (fx - torch.floor(fx))[..., None]
        y1 = torch.clamp(y0 + 1, max=h - 1)
        x1 = torch.remainder(x0 + 1, w)
        gt = ((1 - wy) * ((1 - wx) * tex[y0, x0] + wx * tex[y0, x1])
              + wy * ((1 - wx) * tex[y1, x0] + wx * tex[y1, x1]))
        panes = [gt]
        with _no_tf32():
            basis = torch.stack(sh_basis(torch, x.reshape(-1), y.reshape(-1), z.reshape(-1), 5),
                                dim=1)  # [res*res, 36]
            for d in degrees:
                k = (d + 1) ** 2
                panes.append((basis[:, :k] @ cf[:k]).reshape(res, res, 3))
        strip = torch.cat(panes, dim=1)
        keep = mask.repeat(1, len(panes))[..., None]
        return torch.where(keep, torch.clamp(strip, 0, 1), torch.full_like(strip, 0.08))

    return render


_SH_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>SH demo</title><style>body{background:#111;color:#ddd;
font:13px sans-serif;text-align:center}img{margin-top:20px;cursor:grab;
user-select:none}</style></head><body>
<div>ground truth &middot; degree 1 &middot; degree 3 &middot; degree 4 &middot; degree 5
(drag to scrub, auto-rotating)</div>
<img id="i" draggable="false">
<script>
let a=0, drag=null, spin=true;
const img=document.getElementById('i');
img.addEventListener('mousedown',e=>{drag={x:e.clientX,a0:a};spin=false;e.preventDefault()});
window.addEventListener('mousemove',e=>{if(drag){a=drag.a0+(e.clientX-drag.x)*0.01;}});
window.addEventListener('mouseup',()=>{drag=null;spin=true});
async function loop(){
  if(spin) a+=0.03;
  const r=await fetch('/frame?angle='+a.toFixed(4));
  const b=await r.blob(); const u=URL.createObjectURL(b);
  img.onload=()=>URL.revokeObjectURL(u); img.src=u;
  setTimeout(loop, 30);
}
loop();
</script></body></html>"""


def serve_spheres(img, coeffs, port=8081, host="127.0.0.1", device="cuda", on_ready=None):
    """Serve the rotating-spheres page until interrupted (or until
    ``shutdown()`` of the server that ``on_ready(server)`` receives); each
    ``/frame?angle=`` is a JPEG at quality 90 (PIL's bytes; on the card
    encoded by K11 where the strip was rendered)."""
    render = make_sphere_renderer(img, coeffs, device=device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(200, _SH_PAGE.encode(), "text/html")
            elif url.path == "/frame":
                q = {k: v[-1] for k, v in parse_qs(url.query).items()}
                frame = render(float(q.get("angle", 0.0)))
                # the JAX demo's (frame * 255) cast to uint8, on the device
                body = encode_jpeg((frame * 255).to(torch.uint8), quality=90)
                self._send(200, body, "image/jpeg")
            else:
                self._send(404, b"not found", "text/plain")

    httpd = ThreadingHTTPServer((host, port), Handler)
    print(f"sh demo: http://{host}:{httpd.server_address[1]}/  (ctrl-c to stop)", flush=True)
    if on_ready is not None:
        on_ready(httpd)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--image", help="equirectangular texture, PNG or JPEG (default: procedural)")
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--degree", type=int, default=5)
    ap.add_argument("--out", default="sh_demo.png")
    ap.add_argument("--serve", action="store_true", help="interactive rotating-spheres viewer")
    ap.add_argument("--port", type=int, default=8081)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    h = args.height
    w = 2 * h
    img = load_texture(args.image, w, h, dev) if args.image else procedural_texture(h, w)

    coeffs, basis = fit_sh(img, args.degree, dev)
    if args.serve:
        if args.degree < 5:
            coeffs = np.pad(coeffs, ((0, 36 - coeffs.shape[0]), (0, 0)))
        serve_spheres(img, coeffs, port=args.port, device=dev)
        return

    rows = [img]
    print(f"fit {coeffs.shape[0]} SH bases (degree {args.degree}, {coeffs.size} coefficients)")
    for d in range(args.degree + 1):
        rec = reconstruct(basis, coeffs, d, h, w)
        err = float(np.abs(rec - img).mean())
        print(f"degree {d}: {(d + 1) ** 2:3d} bases, mean |err| = {err:.4f}")
        rows.append(rec.clip(0, 1))

    grid = np.concatenate(rows, axis=0)
    save_png(args.out, (grid * 255).astype(np.uint8))
    print(f"wrote {args.out} (ground truth on top, then degrees 0..{args.degree})")


if __name__ == "__main__":
    main()
