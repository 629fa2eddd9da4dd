"""Carrying a scene and a training state across from the JAX package's
numpy arrays.

The tests feed both packages the same scene and state: the JAX package's
parameter arrays (``pws``, ``shs``, ``alphas``, ``scales``, ``rots`` as
numpy) become float32 tensors here, a JAX camera's numpy leaves (or a camera
dict) become the port's :class:`Camera`, and the leaves of a JAX
``GaussianPool``, ``AdamState`` and ``DensityStats`` become the port's.
``train/checkpoint.py`` reads a checkpoint through these too, a JAX-written
one included, whose PRNG key becomes a generator
(:func:`generator_from_jax_key`).
"""

import numpy as np
import torch

from easygaussiansplatting_tpu_torch.models.camera import Camera
from easygaussiansplatting_tpu_torch.models.gaussians import GROUPS, GaussianPool
from easygaussiansplatting_tpu_torch.train.density import DensityStats
from easygaussiansplatting_tpu_torch.train.optimizer import AdamState
from easygaussiansplatting_tpu_torch.utils.device import resolve_device

PARAM_KEYS = ("pws", "shs", "alphas", "scales", "rots")


def gaussians_from_numpy(d, device="cuda"):
    """{pws [N,3], shs [N,S] (or [N,K,3]), alphas [N] (or [N,1]),
    scales [N,3], rots [N,4]} (numpy or anything array-like) -> dict of
    contiguous float32 tensors on ``device``."""
    dev = resolve_device(device)
    n = len(d["pws"])
    out = {}
    for k in PARAM_KEYS:
        a = np.asarray(d[k], np.float32)
        if k == "shs":
            a = a.reshape(n, -1)
        elif k == "alphas":
            a = a.reshape(n)
        out[k] = torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return out


def camera_from_numpy(cam):
    """A JAX ``Camera`` (anything with Rcw, tcw, fx, fy, cx, cy, width,
    height attributes holding numpy-convertible leaves) or a camera dict ->
    the port's float32 host :class:`Camera`."""
    if isinstance(cam, dict):
        return Camera.from_dict(cam)
    return Camera.from_dict({
        "Rcw": np.asarray(cam.Rcw), "tcw": np.asarray(cam.tcw),
        "fx": np.asarray(cam.fx), "fy": np.asarray(cam.fy),
        "cx": np.asarray(cam.cx), "cy": np.asarray(cam.cy),
        "width": int(cam.width), "height": int(cam.height),
        "id": int(np.asarray(getattr(cam, "id", 0))),
    })


def _tensor(a, dev, dtype=np.float32):
    """A copy (the state is updated in place; it must not alias the source)."""
    return torch.from_numpy(np.array(a, dtype)).to(dev)


def pool_from_numpy(leaves, device="cuda"):
    """{pws, low_shs, high_shs, alphas_raw, scales_raw, rots_raw, alive} (the
    leaves of a JAX ``GaussianPool``, numpy-convertible) -> the port's
    :class:`GaussianPool` on ``device``."""
    dev = resolve_device(device)
    return GaussianPool(*(_tensor(leaves[k], dev) for k in GROUPS),
                        alive=_tensor(leaves["alive"], dev, bool))


def adam_state_from_numpy(count, mu, nu, device="cuda"):
    """A JAX ``AdamState``'s count and its mu / nu dicts of numpy-convertible
    arrays -> the port's :class:`AdamState` on ``device``."""
    dev = resolve_device(device)
    return AdamState(count=int(count), mu={k: _tensor(v, dev) for k, v in mu.items()},
                     nu={k: _tensor(v, dev) for k, v in nu.items()})


def density_stats_from_numpy(grad_accum, cunt, device="cuda"):
    """A JAX ``DensityStats``'s leaves -> the port's on ``device``."""
    dev = resolve_device(device)
    return DensityStats(grad_accum=_tensor(grad_accum, dev), cunt=_tensor(cunt, dev, np.int32))


def generator_from_jax_key(key_words):
    """A CPU ``torch.Generator`` for a JAX PRNG key's two uint32 words,
    seeded with (word0 << 32) | word1. It does not reproduce the JAX key's
    random stream (the two libraries draw differently from one seed): a run
    resumed from a JAX checkpoint continues with the port's own noise."""
    w = np.asarray(key_words, np.uint64).reshape(-1)
    if w.shape != (2,):
        raise ValueError(f"a JAX PRNG key has two uint32 words, got {np.asarray(key_words).shape}")
    return torch.Generator().manual_seed(int((w[0] << np.uint64(32)) | w[1]))
