"""Fixed-capacity Gaussian pool: the trainable model.

Port of easygaussiansplatting_tpu/models/gaussians.py. The pool keeps a fixed
capacity and an ``alive`` mask, as the JAX pool does: prune clears mask bits
and clone/split write into free slots, so no tensor changes shape during
training. Here the pool is an ``nn.Module`` whose six raw (unactivated)
parameter groups are ``nn.Parameter``s and whose ``alive`` mask is a buffer;
densification and the optimiser update them in place.
"""

import numpy as np
import torch
from torch import nn

from easygaussiansplatting_tpu_torch.utils.activations import (
    get_alphas,
    get_alphas_raw,
    get_rots,
    get_scales,
    get_scales_raw,
)
from easygaussiansplatting_tpu_torch.utils.device import resolve_device

SH_REST_DIM = 45  # degree 1..3 coefficients * RGB
GROUPS = ("pws", "low_shs", "high_shs", "alphas_raw", "scales_raw", "rots_raw")


class GaussianPool(nn.Module):
    """pws [CAP,3], low_shs [CAP,3] (degree 0), high_shs [CAP,45] (degrees
    1-3), alphas_raw [CAP] (logit opacity), scales_raw [CAP,3] (log scales),
    rots_raw [CAP,4] (unnormalised wxyz) and the buffer alive [CAP] bool."""

    def __init__(self, pws, low_shs, high_shs, alphas_raw, scales_raw, rots_raw, alive):
        super().__init__()
        for name, t in zip(GROUPS, (pws, low_shs, high_shs, alphas_raw, scales_raw, rots_raw)):
            setattr(self, name, nn.Parameter(t.to(torch.float32).contiguous()))
        self.register_buffer("alive", alive.to(torch.bool))

    @property
    def capacity(self):
        return self.pws.shape[0]

    def n_alive(self):
        return self.alive.sum(dtype=torch.int32)

    def activated(self):
        """(pws, shs [CAP,48], alphas, scales, rots, alive)."""
        return (
            self.pws,
            torch.cat([self.low_shs, self.high_shs], dim=-1),
            get_alphas(self.alphas_raw),
            get_scales(self.scales_raw),
            get_rots(self.rots_raw),
            self.alive,
        )

    def params(self):
        """The trainable groups by name (alive is not trained)."""
        return {name: getattr(self, name) for name in GROUPS}


def pool_from_arrays(pws, rots, scales, alphas, shs, capacity=None, device="cuda"):
    """Build a pool from activated numpy arrays (an SfM init or a loaded
    .ply). ``shs`` may have any multiple-of-3 width <= 48; the missing
    degree-1..3 coefficients take the reference's 0.001 init. Slots past the
    gaussians are dead, with zero parameters and identity rotations."""
    dev = resolve_device(device)
    n = len(pws)
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < number of gaussians {n}")
    shs = np.asarray(shs, np.float32).reshape(n, -1)
    high = np.full((n, SH_REST_DIM), 1e-3, np.float32)
    high[:, : shs.shape[1] - 3] = shs[:, 3:]

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return torch.from_numpy(out).to(dev)

    alive = torch.zeros(cap, dtype=torch.bool)
    alive[:n] = True
    alphas = np.clip(np.asarray(alphas, np.float64).reshape(n), 1e-6, 1 - 1e-6)
    scales = np.maximum(np.asarray(scales, np.float64), 1e-12)
    return GaussianPool(
        pws=pad(np.asarray(pws, np.float32)),
        low_shs=pad(shs[:, :3]),
        high_shs=pad(high),
        alphas_raw=pad(np.asarray(get_alphas_raw(alphas), np.float32)),
        scales_raw=pad(np.asarray(get_scales_raw(scales), np.float32)),
        rots_raw=pad(np.asarray(rots, np.float32), fill=1.0),
        alive=alive.to(dev),
    )
