"""Adaptive density control on the fixed-capacity pool.

Port of easygaussiansplatting_tpu/train/density.py, with the same decision
rules and thresholds:

* prune: alpha < 0.005 or max-scale > 0.1 * scene_size;
* among survivors with mean screen-space gradient >= 4e-7: clone (exact copy)
  if max-scale <= 0.01 * scene_size, else split;
* split: new Gaussian at pw + R(q) @ (noise * scales), with scales * 0.6 for
  the new entry; the original is left untouched;
* alpha reset: clamp alive alphas_raw to logit(0.01) from above and zero the
  alpha group's Adam state.

The JAX functions return new pools and states; these update the pool, the
Adam state and the stats in place under ``torch.no_grad()``. The split noise
is an argument (standard normal, [CAP, 3]): :func:`split_noise` draws it from
an explicit ``torch.Generator``, and a test can hand both packages the same
numbers.
"""

import dataclasses

import torch

from easygaussiansplatting_tpu_torch.train.optimizer import zero_state_rows
from easygaussiansplatting_tpu_torch.utils.activations import (
    get_alphas,
    get_alphas_raw,
    get_rots,
    get_scales,
    get_scales_raw,
)
from easygaussiansplatting_tpu_torch.utils.device import resolve_device
from easygaussiansplatting_tpu_torch.utils.quaternion import rotate_vector_by_quaternion


@dataclasses.dataclass
class DensityStats:
    grad_accum: torch.Tensor  # [CAP] float32 accumulated ||dL/du||
    cunt: torch.Tensor        # [CAP] int32 visibility counts


def density_stats_init(capacity, device="cuda"):
    """Zero stats for a pool of ``capacity`` on ``device`` ("cuda" raises
    without a card)."""
    dev = resolve_device(device)
    return DensityStats(grad_accum=torch.zeros(capacity, dtype=torch.float32, device=dev),
                        cunt=torch.zeros(capacity, dtype=torch.int32, device=dev))


@torch.no_grad()
def update_density_stats(stats, dloss_dus, visible):
    """Accumulate screen-space gradient norms of the visible Gaussians, in
    place (``dloss_dus`` is the gradient of the zero ``us_offset``)."""
    grad = torch.linalg.vector_norm(dloss_dus, dim=-1)
    stats.grad_accum += torch.where(visible, grad, 0.0)
    stats.cunt += visible.to(torch.int32)


def split_noise(capacity, generator, device):
    """Standard-normal split noise [capacity, 3] from ``generator``."""
    return torch.randn((capacity, 3), generator=generator, dtype=torch.float32,
                       device=generator.device).to(device)


@torch.no_grad()
def densify_and_prune(pool, adam_state, stats, noise, scene_size, config):
    """One density update, in place on ``pool``, ``adam_state`` and
    ``stats`` (reset to zero). Returns the report dict of 0-d tensors."""
    cap = pool.capacity
    alive = pool.alive
    alphas = get_alphas(pool.alphas_raw)
    scales = get_scales(pool.scales_raw)
    max_scale = torch.amax(scales, dim=1)

    prune = alive & ((alphas < config.alpha_threshold)
                     | (max_scale > config.big_threshold_scale * scene_size))
    alive = alive & ~prune
    zero_state_rows(adam_state, prune)

    grads_avg = torch.where(stats.cunt > 0,
                            stats.grad_accum / torch.clamp(stats.cunt, min=1), 0.0)
    grads_avg = torch.where(torch.isnan(grads_avg), 0.0, grads_avg)
    selected = alive & (grads_avg >= config.grad_threshold)
    is_small = max_scale <= config.scale_threshold_scale * scene_size
    clone = selected & is_small
    split = selected & ~is_small
    cand = clone | split

    # new-entry parameters for every slot; only candidates are placed
    offset = rotate_vector_by_quaternion(get_rots(pool.rots_raw), noise * scales)
    new_pws = torch.where(split[:, None], pool.pws + offset, pool.pws)
    new_scales_raw = torch.where(split[:, None],
                                 get_scales_raw(scales * config.split_scale_factor),
                                 pool.scales_raw)

    # slot assignment: the k-th candidate goes to the k-th free slot
    free_order = torch.sort(alive.to(torch.uint8), stable=True).indices  # dead first
    cand_order = torch.sort((~cand).to(torch.uint8), stable=True).indices  # candidates first
    n_cand = cand.sum()
    n_new = torch.minimum((~alive).sum(), n_cand)
    k = torch.arange(cap, device=alive.device)
    placed = k < n_new
    # rows not placed write into a scratch row past the end, then drop it
    dst = torch.where(placed, free_order, cap)
    src = cand_order

    def place(dst_arr, src_vals):
        out = torch.cat([dst_arr, dst_arr[:1]])
        out[dst] = src_vals[src]
        return out[:cap]

    filled = torch.zeros(cap + 1, dtype=torch.bool, device=alive.device)
    filled[dst] = True
    filled = filled[:cap]
    for name, vals in (("pws", new_pws), ("low_shs", pool.low_shs),
                       ("high_shs", pool.high_shs), ("alphas_raw", pool.alphas_raw),
                       ("scales_raw", new_scales_raw), ("rots_raw", pool.rots_raw)):
        p = getattr(pool, name)
        p.copy_(place(p, vals))
    pool.alive.copy_(alive | filled)
    zero_state_rows(adam_state, filled)

    stats.grad_accum.zero_()
    stats.cunt.zero_()
    return {
        "n_pruned": prune.sum(),
        "n_cloned": clone.sum(),
        "n_split": split.sum(),
        "n_dropped": n_cand - n_new,
        "n_alive": pool.alive.sum(),
    }


@torch.no_grad()
def reset_alpha(pool, adam_state, config):
    """Clamp alive opacities to reset_alpha_val from above and zero the alpha
    group's Adam state, in place."""
    raw_val = get_alphas_raw(config.reset_alpha_val)
    pool.alphas_raw.copy_(torch.where(pool.alive & (pool.alphas_raw > raw_val), raw_val,
                                      pool.alphas_raw))
    adam_state.mu["alphas_raw"].zero_()
    adam_state.nu["alphas_raw"].zero_()
