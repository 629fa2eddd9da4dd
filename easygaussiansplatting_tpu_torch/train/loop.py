"""The single-camera training step.

Port of easygaussiansplatting_tpu/train/loop.py (``render_pool_image``,
``make_train_step``, ``_round_budget``): one camera per step, loss = 0.8 L1 +
0.2 DSSIM, Adam (eps 1e-15) with per-group learning rates, and the
screen-gradient statistics densification reads. Where the JAX step is a
jitted pure function returning new state, this step updates the pool, the
Adam state and the stats in place and returns the loss and the budget
observation.
"""

import dataclasses

import torch

from easygaussiansplatting_tpu_torch.ops.loss import gau_loss
from easygaussiansplatting_tpu_torch.ops.rasterize import render
from easygaussiansplatting_tpu_torch.ops.stages import MIN_DEPTH
from easygaussiansplatting_tpu_torch.train.config import TrainConfig
from easygaussiansplatting_tpu_torch.train.density import update_density_stats
from easygaussiansplatting_tpu_torch.train.optimizer import adam_update, make_lr_fns
from easygaussiansplatting_tpu_torch.utils.device import resolve_device


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


def make_train_step(config: TrainConfig, scene_size: float, max_steps: int,
                    max_patches=None, device="cuda"):
    """Returns ``train_step(pool, adam_state, stats, cam, gt_image) -> (loss,
    binfo)``. The step renders ``pool`` from ``cam``, takes the loss against
    ``gt_image`` [3,H,W], and updates the pool's parameters, ``adam_state``
    and ``stats`` in place. ``loss`` is a 0-d tensor; ``binfo`` holds the
    budget observation ``obs`` and the patch and row drops ``dropped``, 0-d
    int32 tensors.

    ``device`` is where the pool must lie; "cuda" (the default) raises
    without a card. ``max_patches`` overrides the config's patch budget and
    scales an explicit row budget with it, as the JAX epoch driver's
    ``PatchBudget`` asks (the driver is not ported yet).
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
