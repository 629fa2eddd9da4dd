"""K4's time on the views that decide its design, to compare two checkouts
of the port on one card.

Run as

    python easygaussiansplatting_tpu_torch/probes/k4_views.py [--root DIR]
        [--flush write|read|none] [--f2 JSON] [--chunks L,L,...]

DIR (default: the checkout that holds this file) is the root of the checkout
whose K4 (``ops/kernels/rasterize.py::rasterize_fwd``) is timed; its
kernels build from that checkout's sources, and its own preprocess (K1)
and binning (K12) make K4's inputs. The views:

* ``truck 160x120`` and ``truck 640x480``: the truck_view cell's scene
  (benchmark/configs/truck_view.json, 1,657,258 gaussians drawn on the card
  by ``benchmark.scene.view_scene``) from the viewer's orbit camera at
  azimuth 0, elevation 0.3 (:func:`truck_scene`, which chip_smoke.py's K12
  and K4 phases build on too): the page's preview and its full frame;
* ``F2``, with ``--f2``: view 0 of a synthetic scene, DC colour only, SH
  degree 3, binned at a budget, from a JSON object of
  ``data.synthetic.make_synthetic_scene``'s seed, n_gaussians, n_cams,
  width, height and log_scale_mean and binning's max_patches and max_rows
  (chip_smoke.py passes its render input's).

Each view's K4 is timed twice (``REPS``) by ``ab.event_ms`` (CUDA events
around 20 calls, the L2 flushed before each as ``--flush`` says) and once
by ``ab.device_us`` (its kernels' device time in 10 calls, by
``torch.profiler``). ``--chunks 0,128,256`` also times K4 at each of those
chunk lengths on the views whose tiles its plan cuts into chunks (a
checkout whose wrapper has ``launch_fwd``), to choose its WAVE_DEPTH. A
line a view, then, last, one JSON object with the times, each view's
patches, DIR and the card's name and power limit.
Needs a CUDA device. The harness is this file's (``ab.py`` beside it),
whatever DIR is.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

if __package__:
    from . import ab
else:  # run as a file: its directory is on sys.path
    import ab

REPS = 2  # event timings a view, to show their spread
TRUCK_CONFIG = ab.ROOT / "benchmark" / "configs" / "truck_view.json"
TRUCK_SIZES = ((160, 120), (640, 480))
F2_SCENE = ("seed", "n_gaussians", "n_cams", "width", "height", "log_scale_mean")


def truck_scene(device, look_at_camera):
    """The truck_view cell's scene drawn on the card as the benchmark draws
    it: (config, params, [camera at each of TRUCK_SIZES]), the viewer's
    orbit camera at azimuth 0, elevation 0.3 (SceneRenderer's centre and
    radius). ``look_at_camera`` is data.synthetic's."""
    if str(ab.ROOT) not in sys.path:  # this checkout's benchmark (DIR's stays first)
        sys.path.insert(1, str(ab.ROOT))
    from benchmark.scene import view_scene

    cfg = json.loads(TRUCK_CONFIG.read_text())
    p = view_scene(cfg, device)
    pws = p["pws"].cpu().numpy()
    center = pws.mean(0)
    radius = 2.5 * float(np.percentile(np.linalg.norm(pws - center, axis=1), 90))
    center = center.astype(np.float64)
    el, az = 0.3, 0.0
    pos = center + radius * np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                                      np.sin(el)])
    return cfg, p, [look_at_camera(pos, center, w, h, cfg["fov_f"] * w) for w, h in TRUCK_SIZES]


def f2_view(modules, device, f2):
    """K4's arguments on the ``--f2`` input: (args, kw)."""
    synthetic, _, preprocess, binning = modules
    scene = synthetic.make_synthetic_scene(**{k: f2[k] for k in F2_SCENE})
    n = f2["n_gaussians"]
    shs = np.zeros((n, 48), np.float32)
    shs[:, :3] = scene["shs"]
    p = {k: torch.as_tensor(np.asarray(scene[k], np.float32).reshape(n, -1), device=device)
         for k in ("pws", "scales", "rots")}
    p["shs"] = torch.as_tensor(shs, device=device)
    p["alphas"] = torch.as_tensor(np.asarray(scene["alphas"], np.float32).reshape(n),
                                  device=device)
    cam = scene["cameras"][0]
    pre = preprocess.fused_preprocess(p["pws"], p["shs"], p["alphas"], p["scales"], p["rots"],
                                      cam)
    b = binning.bin_gaussians(pre["us"], pre["depths"], pre["areas"], pre["valid"],
                              width=f2["width"], height=f2["height"],
                              max_patches=f2["max_patches"], max_rows=f2["max_rows"],
                              cinv2ds=pre["cinv2ds"], alphas=pre["alphas"])
    return ((pre["table"], b["patch_gsid"], b["tile_start"], b["tile_cnt"]),
            dict(width=f2["width"], height=f2["height"]))


def truck_views(modules, device):
    """[(label, args, kw)] of K4 on the truck_view scene at TRUCK_SIZES."""
    synthetic, _, preprocess, binning = modules
    cfg, p, cams = truck_scene(device, synthetic.look_at_camera)
    out = []
    for (w, h), cam in zip(TRUCK_SIZES, cams):
        pre = preprocess.fused_preprocess(*(p[k] for k in ("pws", "shs", "alphas", "scales",
                                                           "rots")), cam, sh_degree=3)
        b = binning.bin_gaussians(pre["us"], pre["depths"], pre["areas"], pre["valid"],
                                  width=w, height=h, max_patches=cfg["max_patches"],
                                  cinv2ds=pre["cinv2ds"], alphas=pre["alphas"])
        out.append((f"truck {w}x{h}", (pre["table"], b["patch_gsid"], b["tile_start"],
                                       b["tile_cnt"]), dict(width=w, height=h)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ab.add_root(ap)
    ap.add_argument("--flush", choices=ab.FLUSHES, default="write")
    ap.add_argument("--f2", default="", help="the F2 view's scene and budget, a JSON object")
    ap.add_argument("--chunks", default="", help="chunk lengths to time K4 at, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_views: needs a CUDA device", file=sys.stderr)
        return 2
    modules = ab.import_root(args.root, "data.synthetic", "ops.kernels.rasterize",
                             "ops.kernels.preprocess", "ops.binning")
    rasterize = modules[1]
    smi = ab.card()
    flush = ab.make_flush(args.flush)
    device = torch.device("cuda")
    views = ([("F2", *f2_view(modules, device, json.loads(args.f2)))] if args.f2 else [])
    views += truck_views(modules, device)
    torch.cuda._sleep(int(2e9))  # a second of spinning first, so the clocks have risen
    times, device_us, patches = {}, {}, {}
    for label, a, kw in views:
        def fn(a=a, kw=kw):
            return rasterize.rasterize_fwd(*a, **kw)

        patches[label] = int(a[3].sum())
        times[label] = [ab.event_ms(fn, flush) for _ in range(REPS)]
        device_us[label] = ab.device_us(fn, flush)
        print(f"{label} ({patches[label]} patches): K4 "
              + " / ".join(f"{ms:.4f}" for ms in times[label]) + " ms by events, "
              f"{device_us[label]:.2f} us of device kernels a call (profiler)", flush=True)
        n_tiles = a[3].numel()
        if args.chunks and rasterize.fwd_plan(n_tiles, rasterize.resident_ctas(device))["chunk"]:
            for chunk in (int(c) for c in args.chunks.split(",")):
                plan = rasterize.fwd_plan(n_tiles, rasterize.resident_ctas(device), chunk=chunk)
                ms = ab.event_ms(lambda a=a, kw=kw, plan=plan: rasterize.launch_fwd(
                    *a, plan, **kw), flush)
                times[f"{label} chunk {chunk}"] = [ms]
                print(f"{label} at chunk {chunk}: K4 {ms:.4f} ms by events", flush=True)
    print(smi)
    print(json.dumps({"root": str(Path(args.root).resolve()), "flush": args.flush,
                      "device": smi, "ms": times, "device_us": device_us,
                      "patches": patches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
