"""Train a 3D Gaussian Splatting model on the PyTorch / CUDA port.

Port of the repository's root train.py, single device:

    python -m easygaussiansplatting_tpu_torch.train --path <colmap_dir> [--resize-rate 0.25]
    python -m easygaussiansplatting_tpu_torch.train --synthetic
    python -m easygaussiansplatting_tpu_torch.train --synthetic --device cpu --epochs 1
    python -m easygaussiansplatting_tpu_torch.train --synthetic --resume output/checkpoint.npz

``--path`` trains on a COLMAP scene (``sparse/0/*.bin`` and ``images/``),
its photos decoded and resized on the device (data/dataset.py), started
from its SfM points or from ``--gs``. The synthetic scene is the JAX CLI's:
512 gaussians, 8 views at 128x96, the ground truth rendered from it, and
the training started from its positions with N(0, 0.03) noise and its
colours halved. Writes ``epochNNNN.npy``
snapshots and ``checkpoint.npz`` every ``--save-every`` epochs and at the
end, then ``final.npy`` and ``final.ply``, into ``--out``.

``--preview`` adds a PNG of camera 0 at each save, ``--profile DIR`` writes a
``torch.profiler`` trace of the first epoch (CUDA activity on the card) to
``DIR/trace.json``, and ``--debug-nans`` stops at the first step whose loss
or gradient holds a non-finite value, naming it. ``--monitor-port PORT``
serves the live training monitor (viewer/monitor.py: camera 0 rendered
after every epoch, and the loss and PSNR history) while it trains.
"""

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.data.dataset import load_colmap_dataset
from easygaussiansplatting_tpu_torch.data.gau_io import load_gs, recarray_to_arrays, save_pool
from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene, render_gt_images
from easygaussiansplatting_tpu_torch.models.gaussians import pool_from_arrays
from easygaussiansplatting_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from easygaussiansplatting_tpu_torch.train.config import TrainConfig
from easygaussiansplatting_tpu_torch.train.loop import render_pool_image, train
from easygaussiansplatting_tpu_torch.utils.device import resolve_device
from easygaussiansplatting_tpu_torch.utils.image import save_png, to_uint8
from easygaussiansplatting_tpu_torch.viewer.monitor import TrainingMonitor


def main(argv=None):
    """Run the CLI on ``argv``; returns the epoch driver's history."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--path", help="COLMAP dataset directory")
    ap.add_argument("--resize-rate", type=float, default=0.25,
                    help="photo scale under --path (Pillow's bicubic resize)")
    ap.add_argument("--synthetic", action="store_true", help="train on the synthetic scene")
    ap.add_argument("--gs", help="initial gaussians (.ply/.npy) overriding a COLMAP scene's "
                                 "SfM points; read with --path only, as in train.py, so "
                                 "--synthetic ignores it")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--backend", default="auto", choices=["auto", "cuda", "tiled"])
    ap.add_argument("--capacity", type=int, default=None, help="gaussian pool capacity")
    ap.add_argument("--max-patches", type=int, default=2**20)
    ap.add_argument("--no-adaptive-budget", action="store_true",
                    help="keep max_patches fixed")
    ap.add_argument("--out", default="output")
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", help="checkpoint .npz to resume from")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--preview", action="store_true",
                    help="save a render of camera 0 at each save interval")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler trace of the first epoch to DIR/trace.json")
    ap.add_argument("--debug-nans", action="store_true",
                    help="check every step's loss and gradients, raise on a non-finite value")
    ap.add_argument("--monitor-port", type=int, default=0,
                    help="serve a live training monitor (latest render + loss/PSNR history) "
                         "on this port during training")
    args = ap.parse_args(argv)
    if args.synthetic:
        if args.gs:
            print(f"warning: --gs {args.gs} is ignored: it replaces a COLMAP scene's SfM "
                  "points, and --synthetic starts from the scene's perturbed copy", flush=True)
        dev = resolve_device(args.device)
        scene = make_synthetic_scene(seed=args.seed, n_gaussians=512, n_cams=8, width=128,
                                     height=96)
        cameras = scene["cameras"]
        scene_size = scene["scene_size"]
        images = render_gt_images(scene, device=dev)
        # perturbed init: recover the ground truth
        gs = {k: scene[k] for k in ("pws", "rots", "scales", "alphas", "shs")}
        rng = np.random.default_rng(args.seed)
        gs["pws"] = gs["pws"] + rng.normal(scale=0.03, size=gs["pws"].shape)
        gs["shs"] = gs["shs"] * 0.5
    elif args.path:
        dev = resolve_device(args.device)
        print(f"loading {args.path} (resize {args.resize_rate}) ...", flush=True)
        ds = load_colmap_dataset(args.path, resize_rate=args.resize_rate, device=dev)
        cameras, images, scene_size = ds.cameras, ds.images, ds.scene_size
        gs = recarray_to_arrays(load_gs(args.gs) if args.gs else ds.gs)
        print(f"{len(cameras)} cameras, {len(gs['pws'])} initial gaussians, "
              f"scene_size={scene_size:.2f}", flush=True)
    else:
        ap.error("need --path or --synthetic")

    config = TrainConfig(
        epochs=args.epochs, backend=args.backend, max_patches=args.max_patches,
        save_every_epochs=args.save_every, adaptive_budget=not args.no_adaptive_budget,
    )
    resume = {}
    if args.resume:
        pool, adam_state, stats, epoch0, gen0 = load_checkpoint(args.resume, device=dev)
        resume = dict(adam_state=adam_state, stats=stats, start_epoch=epoch0, generator=gen0)
        print(f"resumed from {args.resume} at epoch {epoch0} (capacity {pool.capacity})")
    else:
        n0 = len(gs["pws"])
        capacity = args.capacity or int(config.capacity_headroom * n0)
        capacity = ((capacity + 255) // 256) * 256
        pool = pool_from_arrays(gs["pws"], gs["rots"], gs["scales"], gs["alphas"], gs["shs"],
                                capacity=capacity, device=dev)
        print(f"pool capacity {capacity} ({n0} alive), backend={args.backend}, device={dev}")

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    def log_fn(msg):
        print(f"{time.strftime('%H:%M:%S')} {msg}", flush=True)

    profiler = []
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler.append(torch.profiler.profile(activities=acts))
        profiler[0].start()

    def stop_profiler():
        if profiler:
            prof = profiler.pop()
            prof.stop()
            trace = Path(args.profile) / "trace.json"
            trace.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(trace))
            log_fn(f"wrote profiler trace to {trace}")

    monitor = None
    if args.monitor_port:
        # live in-browser preview: the latest render of camera 0 and the history
        monitor = TrainingMonitor(cameras[0], config, port=args.monitor_port, log_fn=log_fn)

    def save_cb(epoch, pool, adam_state, stats, generator, history=None):
        if monitor is not None:
            monitor.epoch_cb(epoch, pool, history=history)
        stop_profiler()  # after the first epoch this run trains
        if epoch % config.save_every_epochs == 0 or epoch == config.epochs:
            save_pool(out / f"epoch{epoch:04d}.npy", pool)
            save_checkpoint(out / "checkpoint.npz", pool, adam_state, stats, epoch=epoch,
                            generator=generator)
            if args.preview:
                img, _ = render_pool_image(pool, cameras[0], config, need_grads=False)
                save_png(out / f"preview{epoch:04d}.png", to_uint8(img.cpu().numpy()))

    try:
        pool, history = train(pool, cameras, images, config, scene_size, seed=args.seed,
                              log_fn=log_fn, eval_every=args.eval_every, epoch_cb=save_cb,
                              debug_nans=args.debug_nans, **resume)
    finally:
        if monitor is not None:
            monitor.close()
    stop_profiler()  # no epoch ran
    save_pool(out / "final.npy", pool)
    save_pool(out / "final.ply", pool)  # official-3DGS layout for external viewers
    if history["loss"]:
        log_fn(f"saved {out}/final.npy + .ply; last loss {history['loss'][-1]:.5f}; steps "
               f"that dropped patches or rows: {sum(history['overflow_steps'])}")
    else:  # e.g. resumed at start_epoch >= epochs: nothing left to train
        log_fn(f"saved {out}/final.npy + .ply; no training steps ran")
    return history


if __name__ == "__main__":
    main()
