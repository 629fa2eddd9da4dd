"""Entry points of the port: the forward render and a multi-rank dry run.

Port of the repository's __graft_entry__.py (``entry``,
``dryrun_multichip``), which stays the contract of the JAX package:

* ``entry()`` returns ``(fn, example_args)``: ``fn`` is the forward render
  of 2,048 gaussians at 256x192 through the port's ``render`` (the "cuda"
  backend on the card, max_patches 2^16), its example arguments float32
  tensors on the device.
* ``dryrun_multichip(n)`` starts n ranks (one process each, NCCL on the
  card, gloo with ``device="cpu"``); each runs one batched step over the
  (data, gs) mesh of ``make_mesh(n)`` and one banded step on 128x96 views of
  the same scene and checks that both losses are finite.

    python -m easygaussiansplatting_tpu_torch.graft_entry [--device cpu] [--ranks N]
"""

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene
from easygaussiansplatting_tpu_torch.models.camera import Camera
from easygaussiansplatting_tpu_torch.models.gaussians import pool_from_arrays
from easygaussiansplatting_tpu_torch.ops.rasterize import render
from easygaussiansplatting_tpu_torch.parallel.distributed import (
    free_port,
    init_distributed,
    launch_ranks,
)
from easygaussiansplatting_tpu_torch.parallel.mesh import make_mesh
from easygaussiansplatting_tpu_torch.parallel.train import (
    make_banded_train_step,
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
RANK_TIMEOUT = 600


def _example_scene(n_gaussians, width, height, n_cams=2, seed=0):
    return make_synthetic_scene(seed=seed, n_gaussians=n_gaussians, n_cams=n_cams, width=width,
                                height=height)


def entry(device="cuda"):
    """(fn, example_args): the forward render of the flagship model on
    ``device`` ("cuda" raises without a card; "cpu" takes the plain path)."""
    dev = resolve_device(device)
    width, height = 256, 192
    scene = _example_scene(n_gaussians=2048, width=width, height=height)
    cam = scene["cameras"][0]
    n = scene["pws"].shape[0]
    shs = np.zeros((n, 48), np.float32)
    shs[:, :3] = scene["shs"]
    backend = "cuda" if dev.type == "cuda" else "tiled"

    def fn(pws, shs, alphas, scales, rots, Rcw, tcw, fx, fy, cx, cy):
        c = Camera.from_dict({
            "Rcw": Rcw.cpu(), "tcw": tcw.cpu(), "fx": fx.cpu(), "fy": fy.cpu(),
            "cx": cx.cpu(), "cy": cy.cpu(), "width": width, "height": height})
        image, _ = render(pws, shs, alphas, scales, rots, c, backend=backend,
                          max_patches=2**16, device=pws.device)
        return image

    example_args = tuple(
        torch.as_tensor(np.asarray(x, np.float32), device=dev)
        for x in (scene["pws"], shs, scene["alphas"], scene["scales"], scene["rots"],
                  cam.Rcw, cam.tcw, cam.fx, cam.fy, cam.cx, cam.cy))
    return fn, example_args


def dryrun_multichip(n_devices, device="cuda", timeout=RANK_TIMEOUT):
    """One batched and one banded training step over an n-rank (data, gs)
    mesh, one process a rank, each under ``timeout`` seconds. On "cuda"
    n must not exceed ``torch.cuda.device_count()``. Returns each rank's
    report (mesh shape, both losses, drops); raises if a rank fails."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks need {n_devices} cards; this machine has "
                         f"{torch.cuda.device_count()}")
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    outs = launch_ranks(
        lambda r: [sys.executable, "-m", "easygaussiansplatting_tpu_torch.graft_entry",
                   "--rank", str(r), "--world", str(n_devices), "--port", str(port),
                   "--device", dev.type],
        n_devices, timeout, env=env, cwd=ROOT)
    return [json.loads(out.strip().splitlines()[-1]) for out in outs]


def _dryrun_rank(rank, world, port, device):
    torch.set_num_threads(1)
    dev = init_distributed(f"localhost:{port}", world, rank, device=device)
    mesh = make_mesh(world)
    data, gs = mesh.shape["data"], mesh.shape["gs"]
    # 8x6 = 48 tiles and 2,048 gaussians: tiles and patch lists span the
    # grid, as in the JAX dry run
    width, height = 128, 96
    scene = _example_scene(n_gaussians=2048, width=width, height=height, n_cams=max(2, data))
    cap = ((2560 + gs - 1) // gs) * gs  # divisible by the gs axis
    pool = pool_from_arrays(scene["pws"], scene["rots"], scene["scales"], scene["alphas"],
                            scene["shs"], capacity=cap, device=dev)
    config = TrainConfig(max_patches=2**13)
    pool, adam_state, stats = shard_pool(mesh, pool, adam_init(pool.params()),
                                         density_stats_init(cap, dev))
    cams = stack_cameras(scene["cameras"][:data])
    gt = torch.zeros((data, 3, height, width), dtype=torch.float32, device=dev)
    step = make_sharded_train_step(mesh, config, scene["scene_size"], max_steps=10)
    loss, binfo = step(pool, adam_state, stats, shard_batch(mesh, cams), shard_batch(mesh, gt))
    # the batch < data-axis path: one camera over the whole mesh in bands
    bstep = make_banded_train_step(mesh, config, scene["scene_size"], max_steps=10)
    bloss, bbinfo = bstep(pool, adam_state, stats, scene["cameras"][0], gt[0])
    synchronize(dev)
    report = {"rank": rank, "mesh": [data, gs], "loss": float(loss),
              "banded_loss": float(bloss), "dropped": int(binfo["dropped"]),
              "banded_dropped": int(bbinfo["dropped"])}
    if not (np.isfinite(report["loss"]) and np.isfinite(report["banded_loss"])):
        raise FloatingPointError(f"non-finite loss: {report}")
    torch.distributed.destroy_process_group()
    print(json.dumps(report), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run (default: the cards, or 2 on the CPU)")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)  # a dry run's rank
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _dryrun_rank(args.rank, args.world, args.port, args.device)
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry ok:", tuple(out.shape), float(out.mean()), flush=True)
    ranks = args.ranks or (torch.cuda.device_count() if args.device == "cuda" else 2)
    for report in dryrun_multichip(ranks, args.device):
        print("dryrun_multichip:", json.dumps(report), flush=True)
    print("dryrun_multichip ok", flush=True)


if __name__ == "__main__":
    main()
