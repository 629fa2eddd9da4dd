"""The readings a cell's limits are set from: the program's numbers on many
seeds, the control's (the reference in the program's place, one precision
below the configuration's) and the planted faults'. The benchmark's own
runs never run this.

    python3 benchmark/control.py --workload <cell> --seconds 3 \\
        --program 11 12 ... --control 21 22 23 [--faults 31 32 33]

Prints one JSON line a reading: {"kind", "seed", "checks"}. For training
the control is the reference trainer with TF32 on (the configuration states
float32 with TF32 off), compared by the same numbers with the float32
reference; for the viewer it is the reference render in bfloat16 (the
render states float32) answering the requests in the program's place. The
faults are planted in the program: for training a step that leaves the
state unchanged, one that moves it double, the loss over half the image,
and the opacity gradient halved where it is produced; for the viewer a
stale frame, half the frame left black, one 16-pixel tile column through
the middle of each frame left black (a fault confined to a few tiles), and
a byte of the answer altered.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    return lambda: setattr(obj, name, old)


def train_faults():
    """Planted faults of the training step: name -> function that plants it
    and returns its undo."""
    from easygaussiansplatting_tpu_torch.train import loop

    adam, loss = loop.adam_update, loop.gau_loss

    def double(grads, state, params, *a, **k):
        adam(grads, state, params, *a, **k)
        state.count -= 1
        adam(grads, state, params, *a, **k)

    def half(image, gt, lam=0.2):
        h = image.shape[1] // 2
        return loss(image[:, :h], gt[:, :h], lam)

    def scaled(grads, state, params, *a, **k):
        adam({**grads, "alphas_raw": 0.5 * grads["alphas_raw"]}, state, params, *a, **k)

    return {"unchanged": lambda: _patch(loop, "adam_update", lambda *a, **k: None),
            "double_update": lambda: _patch(loop, "adam_update", double),
            "half_batch": lambda: _patch(loop, "gau_loss", half),
            "answer_altered": lambda: _patch(loop, "adam_update", scaled)}


def view_faults():
    """Planted faults of the viewer: name -> function that plants it and
    returns its undo."""
    from easygaussiansplatting_tpu_torch.viewer import server

    render, encode = server.SceneRenderer.render_device, server.encode_jpeg
    last = {}

    def stale(self, **view):
        out = render(self, **view)
        prev = last.get(tuple(out.shape))
        last[tuple(out.shape)] = out
        return out if prev is None else prev

    def half(self, **view):
        out = render(self, **view).clone()
        out[out.shape[0] // 2:] = 0
        return out

    def column(self, **view):
        out = render(self, **view).clone()
        x = out.shape[1] // 32 * 16
        out[:, x:x + 16] = 0
        return out

    def altered(rgb, quality=90):
        body = bytearray(encode(rgb, quality))
        body[len(body) // 2] ^= 0x10
        return bytes(body)

    return {"stale_frame": lambda: _patch(server.SceneRenderer, "render_device", stale),
            "half_frame": lambda: _patch(server.SceneRenderer, "render_device", half),
            "tile_column": lambda: _patch(server.SceneRenderer, "render_device", column),
            "answer_altered": lambda: _patch(server, "encode_jpeg", altered)}


LOWER = {"float64": "float32", "float32": "bfloat16"}


def view_control(cfg, device="cuda"):
    """Plants the reference render one precision below the configuration's
    (bfloat16 for float32) in the renderer's place."""
    import torch

    from benchmark import scene as bscene
    from benchmark.reference import render as ref_render
    from easygaussiansplatting_tpu_torch.viewer import server

    scene = bscene.view_scene(cfg, device)
    params = {k: v.to(getattr(torch, LOWER[cfg["precision"]])) for k, v in scene.items()}

    def render(self, *, azimuth=0.0, elevation=0.3, radius=None, center=None, width=640,
               height=480, fov_f=0.9, lores=False, **_):
        cam = bscene.orbit_camera(center if center is not None else self.center,
                                  radius or self.radius, azimuth, elevation, width, height, fov_f,
                                  self.LORES_DIV if lores else 1)
        img = ref_render.render(params, cam).float()
        return (torch.clamp(img, 0, 1).permute(1, 2, 0) * 255).to(torch.uint8).contiguous()

    return _patch(server.SceneRenderer, "render_device", render)


def train_control(cfg, seed, device="cuda"):
    """The training control: the reference trainer with TF32 on, its three
    steps taken as the program's, against the float32 reference."""
    import numpy as np
    import torch

    from benchmark import scene as bscene
    from benchmark.drivers import train as drv
    from benchmark.reference import render as ref_render
    from benchmark.reference import train as ref_train

    sc = bscene.synthetic_scene(cfg["gt_seed"], cfg["gt_gaussians"], cfg["views"], cfg["width"],
                                cfg["height"], log_scale_mean=cfg["log_scale_mean"])
    init = bscene.sfm_init(sc, cfg["gt_gaussians"], seed, cfg["init_fraction"],
                           cfg["init_jitter"])
    order = np.random.default_rng(seed).permutation(cfg["views"])[:3].tolist()
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        gt_scene = drv.gt_tensors(sc, dev)
        views = [(sc["cameras"][i], ref_render.render(gt_scene, sc["cameras"][i]))
                 for i in order]
        low = ref_train.steps(init, views, sc["scene_size"], cfg["epochs"] * cfg["views"], dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    program = {"losses": low["losses"], "views": order,
               "snap": {"mu1": {k: (1 - ref_train.B1) * v for k, v in low["grad1"].items()},
                        "p0": low["start"], "p3": low["end"]}}
    return drv.reference_numbers(program, sc, init, cfg, dev)


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--program", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--faults", type=int, nargs="*", default=[])
    args = ap.parse_args()

    from benchmark import harness

    spec = harness.load_spec()
    wl = harness.load_data("workloads", args.workload)
    cfg = harness.load_data("configs", harness.cell_entry(spec, args.workload)["config"])
    train = wl["driver"] == "train"

    def reading(kind, seed, undo=None):
        try:
            run, _ = harness.run_cell(args.workload, seed, args.seconds, False, time.perf_counter())
            checks = {n: v for n, v, _ in run.checks}
        finally:
            if undo is not None:
                undo()
        print(json.dumps({"kind": kind, "seed": seed, "checks": checks}), flush=True)

    for seed in args.program:
        reading("program", seed)
    for seed in args.control:
        if train:
            nums = train_control(cfg, seed)
            print(json.dumps({"kind": "control", "seed": seed,
                              "checks": {k: v for k, v in nums.items()
                                         if isinstance(v, float)}}), flush=True)
        else:
            reading("control", seed, view_control(cfg))
    faults = train_faults() if train else view_faults()
    for seed in args.faults:
        for name, plant in faults.items():
            reading("fault:" + name, seed, plant())


if __name__ == "__main__":
    main()
