"""The patches a view configuration's frames need, to size its
``max_patches``: renders the served scene (the configuration's
``scene_seed``, or each ``--seed``) through the program
from the orbit cameras of the traffic (every azimuth step of a full turn,
elevations over the traffic's range, full frames and previews) and prints
the largest post-cull patch count and tile-row count, and whether any frame
dropped.

    python3 benchmark/size_patches.py --config truck_view [--seed 1 --seed 2 ...]
"""

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, action="append")
    ap.add_argument("--steps", type=int, default=72)
    args = ap.parse_args()

    import torch

    from benchmark import harness
    from benchmark import scene as bscene
    from easygaussiansplatting_tpu_torch.models.camera import Camera
    from easygaussiansplatting_tpu_torch.ops.kernels import _build
    from easygaussiansplatting_tpu_torch.ops.rasterize import render

    _build.build()
    _build.library()
    cfg = harness.load_data("configs", args.config)
    dev = torch.device("cuda")
    out = {}
    for seed in args.seed or [cfg["scene_seed"]]:
        sc = bscene.view_scene(cfg, dev, seed)
        center = sc["pws"].mean(0).tolist()
        radius = 2.5 * float(torch.quantile(torch.linalg.vector_norm(
            sc["pws"][::16] - torch.tensor(center, device=dev), dim=1), 0.9))
        worst = {"total": 0, "total_rows": 0, "dropped": 0}
        for lores in (0, 1):
            for i in range(args.steps):
                az = 2 * math.pi * i / args.steps
                for el in (0.1, 0.3, 0.5):
                    cam = Camera.from_dict(bscene.orbit_camera(
                        center, radius, az, el, cfg["width"], cfg["height"], cfg["fov_f"],
                        cfg["lores_div"] if lores else 1))
                    _, aux = render(sc["pws"], sc["shs"], sc["alphas"], sc["scales"], sc["rots"],
                                    cam, backend="cuda", max_patches=cfg["max_patches"],
                                    need_grads=False, device=dev)
                    b = aux["binning"]
                    worst["total"] = max(worst["total"], int(b["total"]))
                    worst["total_rows"] = max(worst["total_rows"], int(b["total_rows"]))
                    worst["dropped"] += int(b["n_dropped"]) + int(b["rows_dropped"])
        out[seed] = {**worst, "radius": radius}
        print(json.dumps({"seed": seed, **out[seed]}), flush=True)
    print(json.dumps({"max_patches": cfg["max_patches"],
                      "need": max(max(v["total"], v["total_rows"]) for v in out.values())}))


if __name__ == "__main__":
    main()
