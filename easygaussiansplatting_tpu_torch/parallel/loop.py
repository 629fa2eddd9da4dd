"""Sharded epoch loop: batched (or banded) training over a mesh of ranks.

Port of easygaussiansplatting_tpu/parallel/loop.py (``train_sharded``,
``_epoch_batches``): B cameras per step over the mesh's data axis (or, with
``banded``, one camera a step in bands over every rank), keeping the
reference recipe's densify and alpha-reset cadence, with cameras bucketed
by image size. Every rank runs the same program: the same
``np.random.default_rng(seed + start_epoch)`` stream and the same CPU
``torch.Generator`` give every rank the same batches and densify
decisions without any exchange. A densify gathers the pool, Adam state and
stats over gs, runs identically on every rank and goes back to the rows.

Unlike JAX's loop, every step's patch and row drops are counted
(``history["overflow_steps"]``, as the single-device ``train`` keeps them)
and the first overflow is logged; the patch budget stays fixed, as in JAX.
"""

import time
from collections import defaultdict

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.parallel.collectives import all_reduce_
from easygaussiansplatting_tpu_torch.parallel.distributed import fetch_to_host, process_batch_rows
from easygaussiansplatting_tpu_torch.parallel.train import (
    make_banded_train_step,
    make_sharded_render,
    make_sharded_train_step,
    shard_pool,
    stack_cameras,
)
from easygaussiansplatting_tpu_torch.train.density import (
    densify_and_prune,
    density_stats_init,
    reset_alpha,
    split_noise,
)
from easygaussiansplatting_tpu_torch.train.loop import call_epoch_cb
from easygaussiansplatting_tpu_torch.train.optimizer import adam_init
from easygaussiansplatting_tpu_torch.utils.image import psnr


def train_sharded(pool, cameras, gt_images, config, scene_size, mesh, batch=None, seed=0,
                  log_fn=print, eval_every=10, epoch_cb=None, adam_state=None, stats=None,
                  start_epoch=0, generator=None, banded=False, debug_nans=False):
    """Training over ``mesh``, from the full ``pool`` (and ``adam_state``,
    ``stats``, ``start_epoch``, ``generator`` when resuming) held alike by
    every rank. Returns (the full pool, history) on every rank.

    ``banded=True`` trains one camera a step, in bands of tile rows over the
    whole mesh (:func:`make_banded_train_step`): single-host only.
    ``epoch_cb(e, pool, adam_state, stats, generator[, history=])`` runs on
    every rank after each epoch with the full state, gathered over gs (a
    collective every rank joins). Only rank 0 logs through the default
    ``log_fn``. ``debug_nans`` goes to every step."""
    data, gs = mesh.shape["data"], mesh.shape["gs"]
    if banded:
        if mesh.hosts > 1:
            raise ValueError("banded training is single-host (bands reduce over the whole "
                             "mesh)")
        batch = 1
    elif batch is None:
        batch = data
    if not banded and batch % data != 0:
        raise ValueError(f"batch {batch} must be a multiple of the data axis {data}")
    if pool.capacity % gs != 0:
        raise ValueError(f"pool capacity {pool.capacity} not divisible by gs axis {gs}")
    if log_fn is print and mesh.rank != 0:
        log_fn = lambda *a, **k: None  # noqa: E731 -- only rank 0 narrates

    dev = pool.pws.device
    rng = np.random.default_rng(seed + start_epoch)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    n = len(cameras)
    steps_per_epoch = max(1, n // batch)
    max_steps = config.epochs * steps_per_epoch
    if banded:
        step = make_banded_train_step(mesh, config, scene_size, max_steps, debug_nans)
    else:
        step = make_sharded_train_step(mesh, config, scene_size, max_steps, debug_nans)
    render_fn = make_sharded_render(mesh, config)

    buckets = defaultdict(list)
    for i, c in enumerate(cameras):
        buckets[(c.width, c.height)].append(i)
    if adam_state is None:
        adam_state = adam_init(pool.params())
    if stats is None:
        stats = density_stats_init(pool.capacity, dev)
    pool, adam_state, stats = shard_pool(mesh, pool, adam_state, stats)
    my_rows = process_batch_rows(mesh, batch)
    gt_store = [torch.as_tensor(g, dtype=torch.float32, device=dev) for g in gt_images]

    history = {"loss": [], "psnr": [], "n_alive": [], "epoch_time": [], "overflow_steps": []}
    overflow_warned = False
    for epoch in range(start_epoch, config.epochs):
        t0 = time.time()
        losses, drops = [], []
        for idxs in _epoch_batches(buckets, batch, rng):
            if banded:
                loss, binfo = step(pool, adam_state, stats, cameras[idxs[0]], gt_store[idxs[0]])
            else:
                local = [idxs[r] for r in my_rows]
                loss, binfo = step(pool, adam_state, stats,
                                   stack_cameras([cameras[i] for i in local]),
                                   [gt_store[i] for i in local])
            losses.append(loss)
            drops.append(binfo["dropped"])
        avg_loss = float(torch.stack(losses).mean())
        history["loss"].append(avg_loss)
        history["epoch_time"].append(time.time() - t0)
        drops = torch.stack(drops)
        history["overflow_steps"].append(int((drops > 0).sum()))
        if history["overflow_steps"][-1] and not overflow_warned:
            overflow_warned = True
            log_fn(f"[epoch {epoch + 1}] WARNING: patch budget overflow — {int(drops.max())} "
                   f"patches/rows dropped in a step (budget {config.max_patches}, fixed in "
                   f"sharded training)")

        e = epoch + 1
        if e % config.densify_every_epochs == 0 and e <= config.densify_until_epoch and e > 1:
            full = fetch_to_host(mesh, (pool, adam_state, stats))
            noise = split_noise(full[0].capacity, generator, dev)
            report = densify_and_prune(*full, noise, scene_size, config)
            pool, adam_state, stats = shard_pool(mesh, *full)
            log_fn(f"[epoch {e}] densify: pruned={int(report['n_pruned'])} "
                   f"cloned={int(report['n_cloned'])} split={int(report['n_split'])} "
                   f"alive={int(report['n_alive'])}")
        if e % config.reset_alpha_every_epochs == 0 and e < config.epochs:
            # never end training on a reset: the final model would carry the
            # clamped opacities
            reset_alpha(pool, adam_state, config)
            log_fn(f"[epoch {e}] alpha reset")

        n_alive = all_reduce_(pool.n_alive().reshape(1), mesh, "gs", "n_alive")
        history["n_alive"].append(int(n_alive))
        if e % eval_every == 0 or e == config.epochs:
            img = render_fn(pool, cameras[0])
            p = float(psnr(torch.clamp(img, 0, 1), torch.clamp(gt_store[0], 0, 1)))
            history["psnr"].append((e, p))
            log_fn(f"[epoch {e}] loss={avg_loss:.5f} psnr={p:.2f} "
                   f"alive={history['n_alive'][-1]} ({history['epoch_time'][-1]:.1f}s)")
        else:
            log_fn(f"[epoch {e}] loss={avg_loss:.5f} alive={history['n_alive'][-1]} "
                   f"({history['epoch_time'][-1]:.1f}s)")
        if epoch_cb is not None:
            call_epoch_cb(epoch_cb, e, *fetch_to_host(mesh, (pool, adam_state, stats)),
                          generator, history)
    return fetch_to_host(mesh, pool), history


def _epoch_batches(buckets, batch, rng):
    """Shuffled batches of camera indices, each within one (W,H) bucket.
    Short remainders are padded by re-sampling the bucket."""
    out = []
    for idxs in buckets.values():
        order = rng.permutation(idxs)
        for i in range(0, len(order), batch):
            chunk = list(order[i:i + batch])
            while len(chunk) < batch:
                chunk.append(int(rng.choice(idxs)))
            out.append(chunk)
    rng.shuffle(out)
    return out
