"""Render a Gaussian set to a PNG.

Port of the repository's root render.py: loads a .ply/.npy Gaussian file (or
the 4-gaussian example fixture with its 32x16 camera), renders it with the
chosen backend, and writes a PNG. With a file, the camera is the
reference's evaluation view at 979x546; with ``--path``, camera
``--cam-index`` of a COLMAP scene, scaled by ``--resize-rate`` (its photos
are not read).

    python -m easygaussiansplatting_tpu_torch.render --gs trained.ply --out out.png
    python -m easygaussiansplatting_tpu_torch.render --path <colmap_dir> --cam-index 0
    python -m easygaussiansplatting_tpu_torch.render --device cpu   # plain path
    python -m easygaussiansplatting_tpu_torch.render --backend golden   # float64 oracle

Backends: those of ops/rasterize.py (auto, cuda, tiled, dense) and
``golden``, the float64 NumPy oracle of the port's golden/ on the host.
"""

import argparse

import numpy as np

from easygaussiansplatting_tpu_torch import golden
from easygaussiansplatting_tpu_torch.data import example_camera, example_gaussians
from easygaussiansplatting_tpu_torch.data.dataset import load_colmap_dataset
from easygaussiansplatting_tpu_torch.data.gau_io import load_gs, recarray_to_arrays
from easygaussiansplatting_tpu_torch.models import Camera
from easygaussiansplatting_tpu_torch.ops.rasterize import BACKENDS, render
from easygaussiansplatting_tpu_torch.utils.image import save_png, to_uint8


def reference_camera(width=979, height=546):
    Rcw = np.array(
        [
            [0.89699204, 0.06525223, 0.43720409],
            [-0.04508268, 0.99739184, -0.05636552],
            [-0.43974177, 0.03084909, 0.89759429],
        ]
    ).T
    return Camera.from_dict(
        {
            "Rcw": Rcw,
            "tcw": np.array([1.03796196, 0.42017467, 4.67804612]),
            "fx": 581.6273640151177, "fy": 578.140202494143,
            "cx": width / 2, "cy": height / 2,
            "width": width, "height": height,
        }
    )


def load_gaussians(path):
    if path:
        print(f"loading {path}")
        return recarray_to_arrays(load_gs(path))
    print("no gaussian file given; rendering the 4-gaussian example fixture")
    return example_gaussians()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--gs", help="trained gaussians (.ply or .npy)")
    ap.add_argument("--path", help="COLMAP dataset directory (use its cameras)")
    ap.add_argument("--cam-index", type=int, default=0)
    ap.add_argument("--resize-rate", type=float, default=1.0)
    ap.add_argument("--backend", default="auto", choices=[*BACKENDS, "golden"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--width", type=int, default=979)
    ap.add_argument("--height", type=int, default=546)
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--max-patches", type=int, default=2**20)
    args = ap.parse_args(argv)

    gs = load_gaussians(args.gs)
    if args.path:
        ds = load_colmap_dataset(args.path, resize_rate=args.resize_rate, load_images=False,
                                 device=args.device)
        cam = ds.cameras[args.cam_index]
    elif args.gs:
        cam = reference_camera(args.width, args.height)
    else:
        cam = Camera.from_dict(example_camera())
    n = len(gs["pws"])
    shs = np.asarray(gs["shs"]).reshape(n, -1)
    if args.backend == "golden":
        img, _ = golden.render(
            gs["pws"], shs, gs["alphas"], gs["scales"], gs["rots"],
            np.asarray(cam.Rcw, np.float64), np.asarray(cam.tcw, np.float64),
            float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), cam.width, cam.height)
    else:
        degree = int(np.sqrt(max(1, shs.shape[1] // 3))) - 1
        img, _ = render(gs["pws"], shs, gs["alphas"], gs["scales"], gs["rots"], cam,
                        sh_degree=degree, backend=args.backend, max_patches=args.max_patches,
                        need_grads=False, device=args.device)
        img = img.cpu().numpy()
    save_png(args.out, to_uint8(img))
    print(f"wrote {args.out} ({cam.width}x{cam.height}, backend={args.backend}, "
          f"device={args.device}, mean={float(img.mean()):.4f})")


if __name__ == "__main__":
    main()
