"""PyTorch port: the VJP of the fused preprocess (K2's plain version, through
the K2 wrapper and ``PreprocessFunction`` on CPU tensors) against the JAX
fused preprocess run through the Pallas interpreter (which runs
``_bwd_kernel``) and against autodiff of the JAX stages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.data import example_camera
from easygaussiansplatting_tpu.models import Camera as JaxCamera
from easygaussiansplatting_tpu.ops import stages as jax_stages
from easygaussiansplatting_tpu.ops.pallas.preprocess import fused_preprocess as jax_fused
from easygaussiansplatting_tpu.ops.pallas.preprocess import offset_table as jax_offset_table
from easygaussiansplatting_tpu_torch.models.convert import camera_from_numpy
from easygaussiansplatting_tpu_torch.ops.kernels import preprocess

torch.set_num_threads(2)

KEYS = ("pws", "shs", "alphas", "scales", "rots")
# the JAX package's own tolerance between its fused VJP and the stages VJP
# (tests/test_fused_preprocess.py)
TOL = dict(atol=5e-4, rtol=5e-4)
JCAM = JaxCamera.from_dict(example_camera())
CAM = camera_from_numpy(JCAM)


def _pool(rng, n, deg):
    """Random gaussians; a fifth of them behind the camera (depth < 0.2)."""
    pws = rng.normal(size=(n, 3)) * np.array([1.5, 1.0, 1.5])
    # the camera sits near z = -3.8 looking along +z
    pws[: n // 5, 2] = rng.uniform(-10.0, -8.0, size=n // 5)
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    return [a.astype(np.float32) for a in (
        pws, rng.normal(size=(n, 3 * (deg + 1) ** 2)) * 0.5,
        1 / (1 + np.exp(-rng.normal(size=n))), np.exp(rng.normal(size=(n, 3)) * 0.4 - 2.2),
        rots)]


def _port_vjp(arrays, ct, deg, us_ct=None):
    """Gradients of sum(ct * table[:, :9]) through PreprocessFunction (and of
    us_offset when ``us_ct`` is given)."""
    params = [torch.from_numpy(a).requires_grad_() for a in arrays]
    table = preprocess.PreprocessFunction.apply(*params, CAM, deg, True)
    off = torch.zeros((len(arrays[0]), 2), requires_grad=True)
    table, us = preprocess.offset_table(table, off)
    loss = (table[:, :9] * torch.from_numpy(ct)).sum()
    if us_ct is not None:
        loss = loss + (us * torch.from_numpy(us_ct)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, params + [off])]


def _jax_fused_vjp(arrays, ct, deg, us_ct=None):
    def f(*a):
        off = a[5]
        table, us = jax_offset_table(
            jax_fused(*a[:5], JCAM, sh_degree=deg, interpret=True)["table"], off)
        loss = jnp.sum(table[:, :9] * ct)
        if us_ct is not None:
            loss = loss + jnp.sum(us * us_ct)
        return loss
    args = [jnp.asarray(a) for a in arrays] + [jnp.zeros((len(arrays[0]), 2), jnp.float32)]
    return [np.asarray(g) for g in jax.grad(f, argnums=tuple(range(6)))(*args)]


def _jax_stages_vjp(arrays, ct, deg):
    def f(*a):
        o = jax_stages.preprocess(*a, JCAM, sh_degree=deg)
        cols = jnp.concatenate([o["us"], o["cinv2ds"], o["alphas"][:, None], o["colors"]], 1)
        return jnp.sum(cols * ct)
    return [np.asarray(g) for g in
            jax.grad(f, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in arrays))]


# N at and around the CUDA kernel's 128-gaussian blocks: 1, 127, 129, and
# an odd few thousand, beside the original 130
@pytest.mark.parametrize("deg,n", [(0, 130), (3, 130), (3, 1), (3, 127), (3, 129), (0, 3001),
                                   (3, 3001)])
def test_vjp_matches_jax_fused_and_stages(rng, deg, n):
    arrays = _pool(rng, n, deg)
    ct = rng.normal(size=(n, 9)).astype(np.float32)
    got = _port_vjp(arrays, ct, deg)
    fused = _jax_fused_vjp(arrays, ct, deg)
    ref = _jax_stages_vjp(arrays, ct, deg)
    for i, name in enumerate(KEYS):
        np.testing.assert_allclose(got[i], fused[i], **TOL, err_msg=f"{name} vs fused")
        np.testing.assert_allclose(got[i], ref[i], **TOL, err_msg=f"{name} vs stages")
    assert all(np.isfinite(g).all() for g in got)


def test_invalid_gaussians_get_zero_not_nan(rng):
    """A zero cotangent on the gaussians behind the camera (binning gives
    them no patches) yields exactly zero gradient there."""
    arrays = _pool(rng, 60, 3)
    behind = ~preprocess.preprocess_plain(*(torch.from_numpy(a) for a in arrays), CAM)[:, 9].ge(
        0.2).numpy()
    assert behind.sum() >= 10
    ct = rng.normal(size=(60, 9)).astype(np.float32)
    ct[behind] = 0.0
    got = _port_vjp(arrays, ct, 3)
    for g in got[:5]:
        assert np.isfinite(g).all()
        assert np.all(g[behind] == 0.0)


def test_us_offset_gradient(rng):
    arrays = _pool(rng, 40, 0)
    ct = rng.normal(size=(40, 9)).astype(np.float32)
    us_ct = rng.normal(size=(40, 2)).astype(np.float32)
    got = _port_vjp(arrays, ct, 0, us_ct)
    want = _jax_fused_vjp(arrays, ct, 0, us_ct)
    assert np.abs(got[5]).max() > 0
    np.testing.assert_allclose(got[5], want[5], **TOL)
    for i in range(5):
        np.testing.assert_allclose(got[i], want[i], **TOL, err_msg=KEYS[i])


def test_bwd_wrapper_ignores_depth_and_extent_columns(rng):
    params = [torch.from_numpy(a) for a in _pool(rng, 20, 0)]
    ct = torch.from_numpy(rng.normal(size=(20, preprocess.TABLE_COLS)).astype(np.float32))
    live = ct.clone()
    live[:, preprocess.LIVE_COLS:] = 0.0
    for a, b in zip(preprocess.preprocess_bwd(*params, ct, CAM, 0),
                    preprocess.preprocess_bwd(*params, live, CAM, 0)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_bwd_wrapper_rejects_a_bad_cotangent(rng):
    params = [torch.from_numpy(a) for a in _pool(rng, 8, 0)]
    with pytest.raises(ValueError, match="dtable"):
        preprocess.preprocess_bwd(*params, torch.zeros((8, 9)), CAM, 0)
    before = preprocess.preprocess_bwd.launches
    preprocess.preprocess_bwd(*params, torch.zeros((8, preprocess.TABLE_COLS)), CAM, 0)
    assert preprocess.preprocess_bwd.launches == before  # the CPU path launches nothing
