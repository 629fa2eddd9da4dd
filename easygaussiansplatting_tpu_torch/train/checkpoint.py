"""Checkpoint / resume.

Port of easygaussiansplatting_tpu/train/checkpoint.py, in its .npz layout
(host numpy arrays under flat keys): the raw pool parameters and the alive
mask (``pool/*``), the Adam moments and step count (``adam/*``), the
densification stats (``stats/*``) and the epoch counter (``meta/epoch``),
so training restarts bit-exactly. The split-noise generator's state goes
under ``meta/torch_rng`` where the JAX package keeps its PRNG key under
``meta/key``. The two packages read each other's checkpoints.
"""

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.models.convert import (
    adam_state_from_numpy,
    density_stats_from_numpy,
    generator_from_jax_key,
    pool_from_numpy,
)
from easygaussiansplatting_tpu_torch.models.gaussians import GROUPS

POOL_FIELDS = GROUPS + ("alive",)


def _host(t):
    return t.detach().cpu().numpy()


def save_checkpoint(path, pool, adam_state, stats, *, epoch, generator=None):
    """Write the training state to ``path`` (.npz). ``generator``: the CPU
    ``torch.Generator`` of the split noise, whose state is kept."""
    out = {"meta/epoch": np.asarray(epoch, np.int64)}
    if generator is not None:
        out["meta/torch_rng"] = generator.get_state().numpy()
    for f in POOL_FIELDS:
        out[f"pool/{f}"] = _host(getattr(pool, f))
    out["adam/count"] = np.asarray(adam_state.count, np.int32)
    for f in GROUPS:
        out[f"adam/mu/{f}"] = _host(adam_state.mu[f])
        out[f"adam/nu/{f}"] = _host(adam_state.nu[f])
    out["stats/grad_accum"] = _host(stats.grad_accum)
    out["stats/cunt"] = _host(stats.cunt)
    np.savez(path, **out)


def load_checkpoint(path, device="cuda"):
    """Returns (pool, adam_state, stats, epoch, generator or None), the state
    on ``device`` ("cuda" raises without a card). A checkpoint the JAX
    package wrote has no generator state, only ``meta/key``: the generator
    is then seeded from the key's words (models/convert.py
    ``generator_from_jax_key``), which continues the run with the port's own
    noise, not the JAX key's."""
    with np.load(path) as z:
        pool = pool_from_numpy({f: z[f"pool/{f}"] for f in POOL_FIELDS}, device)
        adam_state = adam_state_from_numpy(
            z["adam/count"], {f: z[f"adam/mu/{f}"] for f in GROUPS},
            {f: z[f"adam/nu/{f}"] for f in GROUPS}, device)
        stats = density_stats_from_numpy(z["stats/grad_accum"], z["stats/cunt"], device)
        epoch = int(z["meta/epoch"])
        generator = None
        if "meta/torch_rng" in z:
            generator = torch.Generator()
            generator.set_state(torch.from_numpy(z["meta/torch_rng"]))
        elif "meta/key" in z:
            generator = generator_from_jax_key(z["meta/key"])
    return pool, adam_state, stats, epoch, generator
