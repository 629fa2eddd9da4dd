"""The single-camera training step and the epoch driver.

Port of easygaussiansplatting_tpu/train/loop.py (``render_pool_image``,
``make_train_step``, ``PatchBudget``, ``_round_budget``, ``train``,
``call_epoch_cb``): one camera per step, loss = 0.8 L1 + 0.2 DSSIM, Adam
(eps 1e-15) with per-group learning rates, the screen-gradient statistics
densification reads, and per epoch the adaptive patch budget, densify, prune
and alpha reset. Where the JAX step is a jitted pure function returning new
state, this step updates the pool, the Adam state and the stats in place and
returns the loss and the budget observation.

``StepCache`` and ``PatchBudget.predict`` are not ported: they hide jit
recompiles of the step behind a background thread, and the port compiles
nothing per budget rung. ``train`` builds a new step when the budget
changes, at once.
"""

import dataclasses
import inspect
import time

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.ops.loss import gau_loss
from easygaussiansplatting_tpu_torch.ops.rasterize import render
from easygaussiansplatting_tpu_torch.ops.stages import MIN_DEPTH
from easygaussiansplatting_tpu_torch.train.config import TrainConfig
from easygaussiansplatting_tpu_torch.train.density import (
    densify_and_prune,
    density_stats_init,
    reset_alpha,
    split_noise,
    update_density_stats,
)
from easygaussiansplatting_tpu_torch.train.optimizer import adam_init, adam_update, make_lr_fns
from easygaussiansplatting_tpu_torch.utils.device import resolve_device, synchronize
from easygaussiansplatting_tpu_torch.utils.image import psnr


def render_pool_image(pool, cam, config, us_offset=None, need_grads=True):
    """Render ``pool`` from ``cam`` with the config's backend and budgets;
    ``need_grads=False`` for renders that take no gradient."""
    pws, shs, alphas, scales, rots, alive = pool.activated()
    return render(
        pws, shs, alphas, scales, rots, cam, alive=alive, us_offset=us_offset,
        sh_degree=config.sh_degree, backend=config.backend,
        max_patches=config.max_patches, max_rows=config.max_rows,
        need_grads=need_grads, device=pool.pws.device,
    )


def loss_and_grads(pool, cam, gt_image, config):
    """The loss of ``pool`` rendered from ``cam`` against ``gt_image``
    [3,H,W] and its gradients: (loss detached, {group name: gradient, and
    "us_offset": the screen-space gradient [CAP, 2]}, render aux). Changes
    nothing."""
    params = pool.params()
    us_offset = torch.zeros((pool.capacity, 2), dtype=torch.float32, device=pool.pws.device,
                            requires_grad=True)
    image, aux = render_pool_image(pool, cam, config, us_offset=us_offset)
    loss = gau_loss(image, gt_image, config.loss_lambda)
    grads = torch.autograd.grad(loss, [*params.values(), us_offset])
    return loss.detach(), dict(zip([*params, "us_offset"], grads)), aux


def check_finite(loss, grads):
    """Raise ``FloatingPointError`` naming the loss or the first gradient
    group that holds a non-finite value: the counterpart of JAX's
    ``jax_debug_nans`` for one step. Reads the values on the host."""
    for name, value in (("loss", loss), *grads.items()):
        if not bool(torch.isfinite(value).all()):
            what = "the loss" if name == "loss" else f"the gradient of {name}"
            raise FloatingPointError(f"non-finite values in {what}")


def make_train_step(config: TrainConfig, scene_size: float, max_steps: int,
                    max_patches=None, device="cuda", debug_nans=False):
    """Returns ``train_step(pool, adam_state, stats, cam, gt_image) -> (loss,
    binfo)``. The step renders ``pool`` from ``cam``, takes the loss against
    ``gt_image`` [3,H,W], and updates the pool's parameters, ``adam_state``
    and ``stats`` in place. ``loss`` is a 0-d tensor; ``binfo`` holds the
    budget observation ``obs`` and the patch and row drops ``dropped``, 0-d
    int32 tensors.

    ``device`` is where the pool must lie; "cuda" (the default) raises
    without a card. ``max_patches`` overrides the config's patch budget and
    scales an explicit row budget with it, as :class:`PatchBudget` asks.
    ``debug_nans`` checks the loss and every gradient group with
    :func:`check_finite` (a host sync per step).
    """
    dev = resolve_device(device)
    lr_fns = make_lr_fns(config, scene_size, max_steps)
    if max_patches is not None:
        # an explicit row budget scales with the patch budget (same growth
        # factor), so budget growth relieves both overflow modes
        max_rows = config.max_rows
        if max_rows is not None and max_patches != config.max_patches:
            max_rows = _round_budget(-(-max_rows * max_patches // config.max_patches),
                                     config.budget_quantum)
        config = dataclasses.replace(config, max_patches=max_patches, max_rows=max_rows)

    def train_step(pool, adam_state, stats, cam, gt_image):
        if pool.pws.device.type != dev.type:
            raise ValueError(f"the pool is on {pool.pws.device}, the step on {dev}")
        loss, grads, aux = loss_and_grads(pool, cam, gt_image, config)
        if debug_nans:
            check_finite(loss, grads)
        g_us = grads.pop("us_offset")
        adam_update(grads, adam_state, pool.params(), lr_fns,
                    b1=config.adam_b1, b2=config.adam_b2, eps=config.adam_eps)
        # visibility for the densify stats: in front of the camera and alive
        visible = (aux["depths"].detach() >= MIN_DEPTH) & pool.alive
        update_density_stats(stats, g_us, visible)
        binning = aux["binning"]
        obs = binning["total"]
        if config.max_rows is None:
            obs = torch.maximum(obs, binning["total_rows"])
        else:
            # row pressure in patch-budget units, through the patches/rows ratio
            ratio = torch.full((), config.max_patches / config.max_rows, dtype=torch.float32,
                               device=obs.device)
            rows_obs = (binning["total_rows"].to(torch.float32) * ratio).to(torch.int32)
            obs = torch.maximum(obs, rows_obs)
        binfo = {"obs": obs, "dropped": binning["n_dropped"] + binning["rows_dropped"]}
        return loss, binfo

    return train_step


def _round_budget(n, quantum=16384):
    """Smallest budget rung >= n: quantum * {1,2,3,4,6}, then {8..15} * 2^j
    (steps of about 1.125x)."""
    n = max(n, quantum)
    r = 1
    while r * quantum < n:
        if r < 4:
            r += 1
        elif r < 8:
            r += 2
        else:
            j = r.bit_length() - 4  # r >= 8 so j >= 0
            r = ((r >> j) + 1) << j
    return r * quantum


class PatchBudget:
    """Epoch-granular adaptive max_patches on the :func:`_round_budget`
    ladder: grows to budget_headroom x the observed patch count when that
    nears the budget, shrinks when it falls below half."""

    def __init__(self, config: TrainConfig):
        self.config = config
        self.quantum = config.budget_quantum
        self.value = _round_budget(config.max_patches, self.quantum)

    def update(self, observed_max: int) -> bool:
        """Returns True if the budget changed (the step is rebuilt)."""
        if not self.config.adaptive_budget:
            return False
        want = _round_budget(int(observed_max * self.config.budget_headroom), self.quantum)
        if observed_max > 0.9 * self.value or want < 0.5 * self.value:
            if want != self.value:
                self.value = want
                return True
        return False


def train(pool, cameras, gt_images, config: TrainConfig, scene_size, seed=0, log_fn=print,
          eval_every=10, epoch_cb=None, adam_state=None, stats=None, start_epoch=0,
          generator=None, debug_nans=False):
    """Full training on the pool's device, updating ``pool`` (and
    ``adam_state`` and ``stats`` when given) in place. cameras: list of
    Camera (same W, H); gt_images: list of [3,H,W] images (tensors or
    arrays). Pass adam_state / stats / start_epoch / generator (from
    train.checkpoint.load_checkpoint) to resume. ``generator`` is the CPU
    ``torch.Generator`` of the split noise, seeded with ``seed`` when not
    given. Each epoch's camera order comes from
    ``np.random.default_rng(seed + start_epoch)``, as in the JAX package, so
    a resumed run does not replay an uninterrupted run's order.
    ``debug_nans`` goes to every step (:func:`make_train_step`). Returns
    (pool, history)."""
    dev = pool.pws.device
    rng = np.random.default_rng(seed + start_epoch)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    n = len(cameras)
    max_steps = config.epochs * n
    budget = PatchBudget(config)

    def step_for(max_patches):
        return make_train_step(config, scene_size, max_steps, max_patches=max_patches,
                               device=dev, debug_nans=debug_nans)

    train_step = step_for(budget.value)
    if adam_state is None:
        adam_state = adam_init(pool.params())
    if stats is None:
        stats = density_stats_init(pool.capacity, dev)
    gt_images = [torch.as_tensor(g, dtype=torch.float32, device=dev) for g in gt_images]

    history = {"loss": [], "psnr": [], "n_alive": [], "epoch_time": [],
               "overflow_steps": []}
    overflow_warned = False
    for epoch in range(start_epoch, config.epochs):
        t0 = time.time()
        order = rng.permutation(n)
        losses = []
        patch_peak = []
        drops = []
        # host-vs-device attribution: one step synchronised gives the step's
        # time with its device work finished; the epoch's wall minus
        # n * t_step_device is what the host adds
        t_dev0 = time.time()
        loss0, binfo0 = train_step(pool, adam_state, stats, cameras[order[0]],
                                   gt_images[order[0]])
        synchronize(dev)
        t_step_device = time.time() - t_dev0
        losses.append(loss0)
        patch_peak.append(binfo0["obs"])
        drops.append(binfo0["dropped"])
        for j, i in enumerate(order[1:]):
            loss, binfo = train_step(pool, adam_state, stats, cameras[i], gt_images[i])
            losses.append(loss)
            patch_peak.append(binfo["obs"])
            drops.append(binfo["dropped"])
            # mid-epoch overflow reaction: a densification spike past the
            # patch/row budget must not drop the deepest patches for a whole
            # epoch. j counts from the second step (the first ran above), so
            # the global step index is j + 2; the host reads the drop counts
            # every 16 steps.
            if config.adaptive_budget and (j + 2) % 16 == 0:
                recent = int(torch.stack(drops[-16:]).max())
                if recent > 0:
                    if not overflow_warned:
                        overflow_warned = True
                        log_fn(
                            f"[epoch {epoch + 1}] WARNING: patch budget "
                            f"overflow — {recent} patches/rows dropped in a "
                            f"step (budget {budget.value}); growing budget"
                        )
                    if budget.update(int(torch.stack(patch_peak).max())):
                        log_fn(
                            f"[epoch {epoch + 1}] patch budget -> "
                            f"{budget.value} (mid-epoch overflow)"
                        )
                        train_step = step_for(budget.value)
        # drain: everything still queued on the device finishes here
        avg_loss = float(torch.stack(losses).mean())
        t_drain = time.time()
        history.setdefault("t_steps_wall", []).append(t_drain - t0)
        history.setdefault("t_step_device", []).append(t_step_device)
        history["loss"].append(avg_loss)
        history["epoch_time"].append(time.time() - t0)
        history["overflow_steps"].append(int((torch.stack(drops) > 0).sum()))
        peak = int(torch.stack(patch_peak).max())
        if budget.update(peak):
            log_fn(f"[epoch {epoch + 1}] patch budget -> {budget.value}")
            train_step = step_for(budget.value)

        e = epoch + 1
        t_dfy = time.time()
        if e % config.densify_every_epochs == 0 and e <= config.densify_until_epoch and e > 1:
            noise = split_noise(pool.capacity, generator, dev)
            report = densify_and_prune(pool, adam_state, stats, noise, scene_size, config)
            log_fn(
                f"[epoch {e}] densify: pruned={int(report['n_pruned'])} "
                f"cloned={int(report['n_cloned'])} split={int(report['n_split'])} "
                f"dropped={int(report['n_dropped'])} alive={int(report['n_alive'])}"
            )
        history.setdefault("t_densify", []).append(time.time() - t_dfy)
        if e % config.reset_alpha_every_epochs == 0 and e < config.epochs:
            # never end training on a reset: the final model would carry the
            # clamped opacities
            reset_alpha(pool, adam_state, config)
            log_fn(f"[epoch {e}] alpha reset")

        history["n_alive"].append(int(pool.n_alive()))
        history.setdefault("budget", []).append(int(budget.value))
        if e % eval_every == 0 or e == config.epochs:
            img, _ = render_pool_image(pool, cameras[0], config, need_grads=False)
            p = float(psnr(torch.clamp(img, 0, 1), torch.clamp(gt_images[0], 0, 1)))
            history["psnr"].append((e, p))
            log_fn(f"[epoch {e}] loss={avg_loss:.5f} psnr={p:.2f} alive={history['n_alive'][-1]}")
        else:
            log_fn(f"[epoch {e}] loss={avg_loss:.5f} alive={history['n_alive'][-1]}")
        if epoch_cb is not None:
            call_epoch_cb(epoch_cb, e, pool, adam_state, stats, generator, history)
    return pool, history


def call_epoch_cb(cb, e, pool, adam_state, stats, generator, history):
    """Invoke an epoch callback ``cb(e, pool, adam_state, stats, generator)``;
    pass ``history=`` only to callbacks that accept it."""
    try:
        params = inspect.signature(cb).parameters
        wants_history = "history" in params or any(
            p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()
        )
    except (TypeError, ValueError):
        wants_history = False
    if wants_history:
        cb(e, pool, adam_state, stats, generator, history=history)
    else:
        cb(e, pool, adam_state, stats, generator)
