"""Gaussian viewer: the interactive web viewer, or a headless turntable.

Port of the repository's root gaussian_viewer.py:

* ``--serve`` starts the interactive web viewer (viewer/server.py: mouse
  orbit, pan and zoom, render modes, dataset-camera and point-cloud
  overlays), its frames rendered on the card and sent as JPEG;
* without ``--serve``, renders a headless orbit to an animated GIF (the
  fixed palette of utils/gif.py) and, with ``--save-frames``, PNGs.

    python -m easygaussiansplatting_tpu_torch.gaussian_viewer --gs trained.ply --serve --port 8080
    python -m easygaussiansplatting_tpu_torch.gaussian_viewer --gs trained.ply --out orbit.gif
    python -m easygaussiansplatting_tpu_torch.gaussian_viewer --device cpu --frames 4

``--path`` overlays a COLMAP scene's cameras: as image-textured frusta
under ``--serve`` (the photos read at 1/8 size by the port's loader), as
small markers in a turntable.

``--max-patches`` sets the server's binning budget (default 2^20 patches);
a view that needs more drops the patches of its deepest splats.
``--trace PATH`` traces the server (utils/trace.py): on shutdown it writes
each request's spans as Chrome trace events to PATH (Perfetto opens them),
with binning's counters on the request's record, and prints one line: the
requests served, how many of them dropped splats (patches or tile rows
beyond the budget), and the most tile rows and patches any of them needed.

    python -m easygaussiansplatting_tpu_torch.gaussian_viewer --serve --trace trace.json
"""

import argparse

import numpy as np

from easygaussiansplatting_tpu_torch.data import example_gaussians
from easygaussiansplatting_tpu_torch.data.dataset import load_colmap_dataset, load_image
from easygaussiansplatting_tpu_torch.data.gau_io import load_gs, recarray_to_arrays
from easygaussiansplatting_tpu_torch.utils import trace
from easygaussiansplatting_tpu_torch.utils.device import resolve_device
from easygaussiansplatting_tpu_torch.viewer.headless import (
    camera_markers,
    orbit_cameras,
    render_turntable,
    save_frames,
    save_gif,
)
from easygaussiansplatting_tpu_torch.viewer.server import SceneRenderer, serve


def dataset_overlays(path, skip, device):
    """A COLMAP scene's cameras, their photos at 1/8 size (every skip-th,
    the others None) and its SfM points as a fixed-size point cloud."""
    ds = load_colmap_dataset(path, load_images=False, device=device)
    images = [None] * len(ds.cameras)
    if ds.image_paths:
        for i in range(0, len(ds.cameras), max(1, skip)):
            try:
                images[i] = load_image(ds.image_paths[i], 0.125, device=device).cpu().numpy()
            except OSError:
                pass
    c = recarray_to_arrays(ds.gs)
    spread = float(np.percentile(np.linalg.norm(c["pws"] - c["pws"].mean(0), axis=1), 90)) or 1.0
    cloud = {
        "pws": c["pws"],
        "rots": c["rots"],
        "scales": np.full_like(c["scales"], 0.002 * spread),
        "alphas": np.full_like(np.asarray(c["alphas"]).reshape(-1), 0.9),
        "shs": np.asarray(c["shs"], np.float32).reshape(len(c["pws"]), -1)[:, :3],
    }
    return ds.cameras, images, cloud


def trace_summary(tracer, path):
    """The one line ``--trace`` prints at exit. Binning counts a view's
    patches on the tile rows it kept, so where rows were dropped the
    patches a view needs are more than it counted."""
    reqs = [r.counters for r in tracer.named("viewer.request")]
    renders = [c for c in reqs if "binning.patches" in c]
    dropped = sum(c["binning.dropped"] > 0 or c["binning.rows_dropped"] > 0 for c in renders)
    rows, patches, slots = (max((c[k] for c in renders), default=0)
                            for k in ("binning.rows", "binning.patches", "binning.slots"))
    return (f"trace: {len(reqs)} requests served, {dropped} of {len(renders)} renders dropped "
            f"splats (the most needed {rows:,} tile rows and {patches:,} patches, of "
            f"{slots:,} slots each); wrote {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--serve", action="store_true", help="start the interactive web viewer")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--gs", help="gaussians (.ply/.npy); default: example fixture")
    ap.add_argument("--path", help="COLMAP dataset dir: overlay its cameras")
    ap.add_argument("--skip", type=int, default=5, help="show every skip-th dataset camera")
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--radius", type=float, default=None)
    ap.add_argument("--elevation", type=float, default=0.35)
    ap.add_argument("--backend", default="auto", choices=["auto", "cuda", "tiled"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mode", default="normal", choices=["normal", "ball", "inverse"],
                    help="render mode: ball = hard opaque discs, inverse = negated colours")
    ap.add_argument("--out", default="orbit.gif")
    ap.add_argument("--save-frames", help="also write PNG frames with this prefix")
    ap.add_argument("--max-patches", type=int, default=2**20,
                    help="with --serve: binning's patch budget a frame")
    ap.add_argument("--trace", metavar="PATH",
                    help="with --serve: write the requests' spans and counters as Chrome "
                         "trace events to PATH at exit")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.gs:
        a = recarray_to_arrays(load_gs(args.gs))
    else:
        g = example_gaussians()
        a = {k: g[k] for k in ("pws", "rots", "scales", "alphas", "shs")}

    if args.serve:
        dataset_cameras, dataset_images, cloud = (), None, None
        if args.path:
            dataset_cameras, dataset_images, cloud = dataset_overlays(args.path, args.skip, dev)
        renderer = SceneRenderer(a, dataset_cameras=dataset_cameras,
                                 dataset_images=dataset_images, cloud=cloud,
                                 backend=args.backend, max_patches=args.max_patches,
                                 marker_skip=args.skip, device=dev)
        tracer = trace.enable() if args.trace else None
        try:
            serve(renderer, port=args.port, host=args.host)
        finally:
            if tracer is not None:
                trace.disable()
                tracer.write_chrome(args.trace)
                print(trace_summary(tracer, args.trace), flush=True)
        return

    if args.path:
        ds = load_colmap_dataset(args.path, load_images=False, device=dev)
        markers = camera_markers(ds.cameras[:: max(1, args.skip)])
        sw = np.asarray(a["shs"], np.float32).reshape(len(a["pws"]), -1).shape[1]
        msh = np.zeros((len(markers["pws"]), sw), np.float32)
        msh[:, :3] = markers["shs"]
        markers["shs"] = msh
        a = {k: np.concatenate(
            [np.asarray(a[k], np.float32).reshape(len(a["pws"]), -1).squeeze(),
             markers[k].squeeze()]) for k in a}

    if args.mode == "ball":
        a["alphas"] = np.full_like(np.asarray(a["alphas"], np.float32), 0.99)
        a["scales"] = np.asarray(a["scales"], np.float32) * 0.6
    elif args.mode == "inverse":
        # color = sum c.Y + 0.5, so negating the coefficients gives 1 - color
        a["shs"] = -np.asarray(a["shs"], np.float32)

    cameras = None
    if args.radius is not None:
        center = np.asarray(a["pws"], np.float64).mean(0)
        cameras = orbit_cameras(center, args.radius, n_frames=args.frames, width=args.width,
                                height=args.height, elevation=args.elevation)

    frames = render_turntable(a, cameras, backend=args.backend, device=dev,
                              n_frames=args.frames, width=args.width, height=args.height,
                              elevation=args.elevation)
    if args.out:
        save_gif(args.out, frames)
        print(f"wrote {args.out} ({len(frames)} frames, {args.width}x{args.height})")
    if args.save_frames:
        save_frames(args.save_frames, frames)
        print(f"wrote {len(frames)} PNGs at {args.save_frames}*")


if __name__ == "__main__":
    main()
