"""PyTorch port: SSIM and the training loss against the JAX loss, values and
image gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.ops import loss as jax_loss
from easygaussiansplatting_tpu_torch.ops import loss

torch.set_num_threads(2)

# float32 band-matrix products summed in another order than XLA's: 1e-6
TOL = dict(atol=1e-6, rtol=1e-6)


def _pair(seed, h=32, w=48):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(3, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(size=(3, h, w)) * 0.1, 0, 1).astype(np.float32)
    return a, b


def test_blur_matrix_matches_jax():
    for n in (1, 7, 32):
        np.testing.assert_array_equal(loss._blur_matrix(n, torch.device("cpu")).numpy(),
                                      np.asarray(jax_loss._blur_matrix(n)))


@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_and_loss_values_match_jax(seed):
    a, b = _pair(seed)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(loss.ssim(ta, tb)),
                               float(jax_loss.ssim(jnp.asarray(a), jnp.asarray(b))), **TOL)
    for lam in (0.2, 0.5):
        np.testing.assert_allclose(
            float(loss.gau_loss(ta, tb, lam)),
            float(jax_loss.gau_loss(jnp.asarray(a), jnp.asarray(b), lam)), **TOL)


def test_loss_image_gradient_matches_jax():
    a, b = _pair(2, h=24, w=40)
    ta = torch.from_numpy(a).requires_grad_()
    (got,) = torch.autograd.grad(loss.gau_loss(ta, torch.from_numpy(b)), ta)
    want = jax.grad(jax_loss.gau_loss)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
