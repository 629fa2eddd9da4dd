"""Masked per-group Adam with direct state access.

Port of easygaussiansplatting_tpu/train/optimizer.py, a small explicit
implementation rather than ``torch.optim.Adam``: densification zeroes rows
of the moments directly. Semantics match torch.optim.Adam (eps added outside
the sqrt) with eps = 1e-15. One ``count`` is shared by all groups and kept
on the host, so reading the learning rate never waits for the device; each
group's learning rate is read at the count before the increment.

The update is in place: :func:`adam_update` and :func:`zero_state_rows`
overwrite the parameters and the moments under ``torch.no_grad()`` (the JAX
functions return new arrays instead).
"""

import dataclasses

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.utils.schedule import get_expon_lr_func


@dataclasses.dataclass
class AdamState:
    count: int   # steps taken
    mu: dict     # group name -> tensor shaped like the parameter
    nu: dict


def adam_init(params):
    return AdamState(count=0,
                     mu={k: torch.zeros_like(p, requires_grad=False) for k, p in params.items()},
                     nu={k: torch.zeros_like(p, requires_grad=False) for k, p in params.items()})


def make_lr_fns(config, scene_size, max_steps):
    """Per-group learning rates; pws follows the log-lerp decay schedule."""
    pws_sched = get_expon_lr_func(
        lr_init=config.lr_pws_init_scale * scene_size,
        lr_final=config.lr_pws_final_scale * scene_size,
        lr_delay_mult=config.lr_delay_mult,
        max_steps=max_steps,
    )
    return {
        "pws": pws_sched,
        "low_shs": lambda step: config.lr_low_shs,
        "high_shs": lambda step: config.lr_high_shs,
        "alphas_raw": lambda step: config.lr_alphas,
        "scales_raw": lambda step: config.lr_scales,
        "rots_raw": lambda step: config.lr_rots,
    }


@torch.no_grad()
def adam_update(grads, state, params, lr_fns, b1=0.9, b2=0.999, eps=1e-15):
    """One Adam step, in place on ``params`` and ``state``. lr_fns: dict
    group name -> fn(step) -> lr."""
    cf = np.float32(state.count + 1)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** cf)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** cf)
    for k, p in params.items():
        g = grads[k]
        mu = state.mu[k].mul_(b1).add_((1.0 - b1) * g)
        nu = state.nu[k].mul_(b2).add_((1.0 - b2) * g * g)
        lr = lr_fns[k](state.count)
        p.sub_(lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps))
    state.count += 1


@torch.no_grad()
def zero_state_rows(state, mask):
    """Zero the moment rows where ``mask`` [CAP] is true (freed or newly
    filled slots restart with clean optimiser state)."""
    for moments in (state.mu, state.nu):
        for x in moments.values():
            x.masked_fill_(mask.reshape((-1,) + (1,) * (x.dim() - 1)), 0.0)
