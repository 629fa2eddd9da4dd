"""PyTorch port: activations, quaternions, the learning-rate schedule, the SH
basis gradient and the budget ladder against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.train.loop import _round_budget as jax_round_budget
from easygaussiansplatting_tpu.utils import activations as jax_act
from easygaussiansplatting_tpu.utils import quaternion as jax_quat
from easygaussiansplatting_tpu.utils.schedule import get_expon_lr_func as jax_lr
from easygaussiansplatting_tpu.utils.sh import sh_basis_grad as jax_sh_basis_grad
from easygaussiansplatting_tpu_torch.train.loop import _round_budget
from easygaussiansplatting_tpu_torch.utils import activations, quaternion
from easygaussiansplatting_tpu_torch.utils.schedule import get_expon_lr_func
from easygaussiansplatting_tpu_torch.utils.sh import sh_basis, sh_basis_grad

torch.set_num_threads(2)

# float32 transcendental functions of numpy/XLA and torch may differ by an
# ulp or two: 1e-6 relative (and absolute near zero)
TOL = dict(atol=1e-6, rtol=1e-6)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_activations_match_jax(rng):
    raw = _f32(rng, 50, scale=3.0)
    np.testing.assert_allclose(activations.get_alphas(torch.from_numpy(raw)).numpy(),
                               np.asarray(jax_act.get_alphas(jnp.asarray(raw))), **TOL)
    a = (1 / (1 + np.exp(-raw))).astype(np.float32)
    np.testing.assert_allclose(activations.get_alphas_raw(torch.from_numpy(a)).numpy(),
                               np.asarray(jax_act.get_alphas_raw(jnp.asarray(a))), **TOL)
    s = _f32(rng, 50, 3)
    np.testing.assert_allclose(activations.get_scales(torch.from_numpy(s)).numpy(),
                               np.asarray(jax_act.get_scales(jnp.asarray(s))), **TOL)
    e = np.exp(s)
    np.testing.assert_allclose(activations.get_scales_raw(torch.from_numpy(e)).numpy(),
                               np.asarray(jax_act.get_scales_raw(jnp.asarray(e))), **TOL)
    q = _f32(rng, 50, 4)
    np.testing.assert_allclose(activations.get_rots(torch.from_numpy(q)).numpy(),
                               np.asarray(jax_act.get_rots(jnp.asarray(q))), **TOL)
    lo, hi = _f32(rng, 5, 3), _f32(rng, 5, 45)
    np.testing.assert_array_equal(activations.get_shs(torch.from_numpy(lo),
                                                      torch.from_numpy(hi)).numpy(),
                                  np.asarray(jax_act.get_shs(jnp.asarray(lo), jnp.asarray(hi))))
    # floats and numpy arrays take the same definitions
    assert activations.get_alphas_raw(0.01) == jax_act.get_alphas_raw(0.01)
    assert activations.get_scales_raw(0.5) == jax_act.get_scales_raw(0.5)
    np.testing.assert_allclose(activations.get_alphas(raw), jax_act.get_alphas(raw), **TOL)


def test_quaternions_match_jax(rng):
    q = _f32(rng, 40, 4)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    v = _f32(rng, 40, 3)
    np.testing.assert_allclose(quaternion.quaternion_to_matrix(torch.from_numpy(qn)).numpy(),
                               np.asarray(jax_quat.quaternion_to_matrix(jnp.asarray(qn))),
                               **TOL)
    got = quaternion.rotate_vector_by_quaternion(torch.from_numpy(q), torch.from_numpy(v))
    want = jax_quat.rotate_vector_by_quaternion(jnp.asarray(q), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("delay_steps,delay_mult", [(0, 0.01), (100, 0.01)])
def test_expon_lr_matches_jax(delay_steps, delay_mult):
    kw = dict(lr_init=1e-4 * 5.5, lr_final=1e-6 * 5.5, lr_delay_steps=delay_steps,
              lr_delay_mult=delay_mult, max_steps=3000)
    ours, theirs = get_expon_lr_func(**kw), jax_lr(**kw)
    for step in (0, 1, 7, 50, 100, 1499, 3000, 4000):
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6, err_msg=step)
    assert get_expon_lr_func(0.0, 0.0)(5) == 0.0


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_basis_grad_matches_jax(rng, deg):
    d = _f32(rng, 64, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = sh_basis_grad(torch, *(torch.from_numpy(d[:, i]) for i in range(3)), deg)
    want = jax_sh_basis_grad(jnp, *(jnp.asarray(d[:, i]) for i in range(3)), deg)
    assert len(got) == len(want) == (deg + 1) ** 2
    for k, (g, w) in enumerate(zip(got, want)):
        for a in range(3):
            np.testing.assert_allclose(g[a].numpy(), np.asarray(w[a]), atol=2e-6, rtol=1e-5,
                                       err_msg=f"basis {k} axis {a}")


@pytest.mark.parametrize("deg", [4, 5])
def test_sh_basis_grad_matches_autograd(rng, deg):
    """Degrees 4-5 (the JAX package covers 0-3): against torch autograd of
    the basis polynomials in float64."""
    d = torch.from_numpy(rng.normal(size=(32, 3))).requires_grad_()
    basis = sh_basis(torch, d[:, 0], d[:, 1], d[:, 2], deg)
    got = sh_basis_grad(torch, d[:, 0].detach(), d[:, 1].detach(), d[:, 2].detach(), deg)
    for k, b in enumerate(basis):
        if not b.requires_grad:  # the constant Y0,0
            want = torch.zeros_like(d)
        else:
            (want,) = torch.autograd.grad(b.sum(), d, retain_graph=True)
        for a in range(3):
            torch.testing.assert_close(got[k][a], want[:, a], atol=1e-12, rtol=1e-10)


def test_round_budget_matches_jax():
    for n in (1, 16384, 16385, 70000, 557056, 589825, 3_000_000):
        assert _round_budget(n) == jax_round_budget(n), n
