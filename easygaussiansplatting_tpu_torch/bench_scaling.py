"""Scaling benchmark: pixels/s of the batched train step against the number
of ranks.

Port of the repository's scripts/bench_scaling.py, with its flags and JSON
keys, plus ``--device``. For each world size d (1, 2, 4, ... up to the
cards, or ``--devices``) it starts d ranks (one process each: NCCL on the
card, gloo on the CPU) on a pure data-parallel mesh (d, 1), times the
median of ``--trials`` trials of ``--steps`` steps of d cameras, and prints
pixels/s and the efficiency against d x the one-rank rate. ``--virtual N``
runs N gloo ranks on the CPU (world sizes up to 2 unless ``--devices`` is
given, as in JAX): that checks the program, not a speed-up, since the ranks
share the host. With one world size (one card) no scaling is measured, and
the JSON line says so.

    python -m easygaussiansplatting_tpu_torch.bench_scaling [--devices 8] [--width 256 --height 192]
    python -m easygaussiansplatting_tpu_torch.bench_scaling --virtual 2
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene, render_gt_images
from easygaussiansplatting_tpu_torch.models.gaussians import pool_from_arrays
from easygaussiansplatting_tpu_torch.parallel.distributed import (
    free_port,
    init_distributed,
    launch_ranks,
    make_multihost_mesh,
    process_batch_rows,
)
from easygaussiansplatting_tpu_torch.parallel.mesh import make_mesh
from easygaussiansplatting_tpu_torch.parallel.train import (
    make_sharded_train_step,
    shard_batch,
    shard_pool,
    stack_cameras,
)
from easygaussiansplatting_tpu_torch.train.config import TrainConfig
from easygaussiansplatting_tpu_torch.train.density import density_stats_init
from easygaussiansplatting_tpu_torch.train.optimizer import adam_init
from easygaussiansplatting_tpu_torch.utils.device import resolve_device, synchronize

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 900
TARGET_EFFICIENCY = 0.70  # the JAX script's vs_baseline anchor


def _parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--virtual", type=int, default=None, help="run N gloo ranks on the CPU")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--gaussians", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trials", type=int, default=5,
                    help="timed repetitions per world size; the median trial is reported")
    ap.add_argument("--multihost", action="store_true",
                    help="join a multi-process run (EGS_COORDINATOR / EGS_NUM_PROCESSES / "
                         "EGS_PROCESS_ID) and time the step over the whole mesh")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)  # a world size's rank
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--n-cams", type=int, help=argparse.SUPPRESS)
    return ap


def _setup(args, mesh, dev, n_cams):
    """The scene, the sharded state and this rank's cameras and images."""
    config = TrainConfig(max_patches=2**13)
    scene = make_synthetic_scene(seed=0, n_gaussians=args.gaussians, n_cams=n_cams,
                                 width=args.width, height=args.height, log_scale_mean=-3.0)
    gts = render_gt_images(scene, config, device=dev)
    cap = ((args.gaussians * 2 + 255) // 256) * 256
    pool = pool_from_arrays(scene["pws"], scene["rots"], scene["scales"], scene["alphas"],
                            scene["shs"], capacity=cap, device=dev)
    step = make_sharded_train_step(mesh, config, scene["scene_size"], 100)
    state = shard_pool(mesh, pool, adam_init(pool.params()), density_stats_init(cap, dev))
    batch = mesh.shape["data"]
    cams = shard_batch(mesh, stack_cameras(scene["cameras"][:batch]))
    gt = shard_batch(mesh, torch.stack(gts[:batch]))
    return step, state, cams, gt


def _time_steps(step, state, cams, gt, dev, steps, trials):
    """(median seconds a step over ``trials`` trials of ``steps``, the last
    loss); one warm step first."""
    loss, _ = step(*state, cams, gt)
    synchronize(dev)
    dts = []
    for _ in range(max(1, trials)):
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, _ = step(*state, cams, gt)
        float(loss)
        synchronize(dev)
        dts.append((time.perf_counter() - t0) / steps)
    return float(np.median(dts)), float(loss)


def _rank(args):
    """One rank of a world size: prints the timing as a JSON line (rank 0)."""
    torch.set_num_threads(1)
    dev = init_distributed(f"localhost:{args.port}", args.world, args.rank, device=args.device)
    mesh = make_mesh(args.world, data=args.world)  # pure data parallelism over cameras
    step, state, cams, gt = _setup(args, mesh, dev, args.n_cams)
    dt, loss = _time_steps(step, state, cams, gt, dev, args.steps, args.trials)
    dist.destroy_process_group()
    if args.rank == 0:
        print(json.dumps({"devices": args.world, "step_s": dt, "loss": loss}), flush=True)


def _run_multihost(args):
    """The whole process-spanning mesh, timed once (every rank runs this)."""
    dev = init_distributed(device=args.device)
    mesh = make_multihost_mesh()
    batch = mesh.shape["data"]
    process_batch_rows(mesh, batch)  # the divisibility check
    step, state, cams, gt = _setup(args, mesh, dev, batch)
    dt, loss = _time_steps(step, state, cams, gt, dev, args.steps, 1)
    pix_s = batch * args.width * args.height / dt
    if dist.get_rank() == 0:
        print(f"{mesh.hosts} hosts, {mesh.size} ranks: step {dt * 1e3:.2f} ms  "
              f"{pix_s / 1e6:.3f} Mpix/s  loss {loss:.5f}", flush=True)
        print(json.dumps({"metric": "multihost_pixels_per_s", "value": round(pix_s / 1e6, 6),
                          "unit": f"Mpix/s over {mesh.hosts} hosts", "vs_baseline": 0.0}))


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.rank is not None:
        return _rank(args)
    if args.multihost:
        return _run_multihost(args)
    if args.virtual:
        args.device = "cpu"
    dev = resolve_device(args.device)
    if args.virtual:
        n_dev = args.devices or args.virtual
    else:
        n_dev = args.devices or (torch.cuda.device_count() if dev.type == "cuda" else 1)
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    if dev.type == "cpu" and not args.devices:
        # CPU ranks share one host; 2 suffice to check the program
        sizes = [d for d in sizes if d <= 2]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    base, rows = None, []
    for d in sizes:
        port = free_port()
        outs = launch_ranks(
            lambda r: [sys.executable, "-m", "easygaussiansplatting_tpu_torch.bench_scaling",
                       *(argv if argv is not None else sys.argv[1:]), "--device", dev.type,
                       "--rank", str(r), "--world", str(d), "--port", str(port),
                       "--n-cams", str(max(sizes))],
            d, RANK_TIMEOUT, env=env, cwd=ROOT)
        res = json.loads(outs[0].strip().splitlines()[-1])
        dt = res["step_s"]
        pix_s = d * args.width * args.height / dt
        base = base or pix_s
        eff = pix_s / (base * d)
        rows.append((d, eff))
        print(f"devices={d:3d}  step {dt * 1e3:8.2f} ms  {pix_s / 1e6:8.3f} Mpix/s  "
              f"efficiency {eff * 100:5.1f}%", flush=True)
    d, eff = rows[-1]
    out = {"metric": "scaling_efficiency", "value": round(eff, 3),
           "unit": f"fraction at {d} devices", "vs_baseline": round(eff / TARGET_EFFICIENCY, 3),
           "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"}
    if len(rows) == 1:
        out.update(value=None, vs_baseline=None,
                   note="one world size: no scaling is measured")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
