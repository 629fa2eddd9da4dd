"""Parameter activations mapping raw (optimised) values to physical ones.

Port of easygaussiansplatting_tpu/utils/activations.py: alphas =
sigmoid(raw), scales = exp(raw), rots = L2-normalised raw quaternions, shs =
the degree-0 block followed by the degree-1..3 block. Each function takes a
torch tensor, a numpy array or (for the inverse maps) a Python float, and
answers in the same kind; the expressions are the JAX package's, so float32
inputs round where the JAX ones do.
"""

import math

import numpy as np
import torch


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


def get_alphas(alphas_raw):
    return 1.0 / (1.0 + _xp(alphas_raw).exp(-alphas_raw))


def get_alphas_raw(alphas):
    if isinstance(alphas, float):
        return math.log(alphas / (1.0 - alphas))
    return _xp(alphas).log(alphas / (1.0 - alphas))


def get_scales(scales_raw):
    return _xp(scales_raw).exp(scales_raw)


def get_scales_raw(scales):
    if isinstance(scales, float):
        return math.log(scales)
    return _xp(scales).log(scales)


def get_rots(rots_raw):
    if isinstance(rots_raw, torch.Tensor):
        return rots_raw / torch.linalg.vector_norm(rots_raw, dim=-1, keepdim=True)
    return rots_raw / np.linalg.norm(rots_raw, axis=-1, keepdims=True)


def get_shs(low_shs, high_shs):
    if isinstance(low_shs, torch.Tensor):
        return torch.cat([low_shs, high_shs], dim=-1)
    return np.concatenate([low_shs, high_shs], axis=-1)
