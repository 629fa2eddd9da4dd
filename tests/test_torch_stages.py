"""PyTorch port: stages 1-5 (the plain version of K1) and the K1 wrapper
against the JAX stages, the JAX fused Pallas preprocess (interpreted) and the
float64 golden model."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu import golden
from easygaussiansplatting_tpu.data import example_camera, example_gaussians
from easygaussiansplatting_tpu.models import Camera as JaxCamera
from easygaussiansplatting_tpu.ops import stages as jax_stages
from easygaussiansplatting_tpu.ops.pallas.preprocess import fused_preprocess as jax_fused
from easygaussiansplatting_tpu_torch.models.convert import camera_from_numpy, gaussians_from_numpy
from easygaussiansplatting_tpu_torch.ops import stages
from easygaussiansplatting_tpu_torch.ops.kernels import preprocess

torch.set_num_threads(2)

KEYS = ("pws", "shs", "alphas", "scales", "rots")
OUT_KEYS = ("us", "cinv2ds", "colors", "depths", "areas")


def _pool(rng, n, deg):
    pws = rng.normal(size=(n, 3)) * np.array([1.5, 1.0, 1.5])
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    return {
        "pws": pws, "rots": rots,
        "scales": np.exp(rng.normal(size=(n, 3)) * 0.4 - 2.2),
        "alphas": 1 / (1 + np.exp(-rng.normal(size=n))),
        "shs": rng.normal(size=(n, 3 * (deg + 1) ** 2)) * 0.5,
    }


def _both(d):
    jax_args = [jnp.asarray(d[k], jnp.float32) for k in KEYS]
    t = gaussians_from_numpy(d, device="cpu")
    return jax_args, [t[k] for k in KEYS]


@pytest.mark.parametrize("deg,n", [(0, 120), (3, 257), (3, 1000)])
def test_preprocess_matches_jax_stages_and_fused(rng, deg, n):
    jcam = JaxCamera.from_dict(example_camera())
    cam = camera_from_numpy(jcam)
    jax_args, args = _both(_pool(rng, n, deg))
    ref = jax_stages.preprocess(*jax_args, jcam, sh_degree=deg)
    fused = jax_fused(*jax_args, jcam, sh_degree=deg, interpret=True)
    out = stages.preprocess(*args, cam, sh_degree=deg)
    out_k = preprocess.fused_preprocess(*args, cam, sh_degree=deg)  # K1 wrapper, CPU
    for key in OUT_KEYS:
        for want in (ref[key], fused[key]):
            for got in (out[key], out_k[key]):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           atol=2e-5, rtol=2e-5, err_msg=key)
    for key in ("pcs", "cov3ds", "cov2ds"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=2e-5, rtol=2e-5, err_msg=key)
    np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref["valid"]))
    np.testing.assert_array_equal(out_k["valid"].numpy(), np.asarray(fused["valid"]))


def test_preprocess_matches_golden_on_fixture():
    gs = example_gaussians()
    camd = example_camera()
    _, aux_g = golden.render(
        gs["pws"], gs["shs"], gs["alphas"], gs["scales"], gs["rots"], camd["Rcw"],
        camd["tcw"], camd["fx"], camd["fy"], camd["cx"], camd["cy"],
        camd["width"], camd["height"],
    )
    t = gaussians_from_numpy(gs, device="cpu")
    out = stages.preprocess(*(t[k] for k in KEYS), camera_from_numpy(camd), sh_degree=0)
    for key in ("us", "pcs", "depths", "cov3ds", "cov2ds", "colors", "cinv2ds", "areas"):
        np.testing.assert_allclose(out[key].numpy(), aux_g[key], atol=1e-4, rtol=1e-4,
                                   err_msg=key)


def test_alive_mask(rng):
    jcam = JaxCamera.from_dict(example_camera())
    d = _pool(rng, 64, 0)
    jax_args, args = _both(d)
    alive = rng.random(64) < 0.5
    ref = jax_stages.preprocess(*jax_args, jcam, alive=jnp.asarray(alive), sh_degree=0)
    out = preprocess.fused_preprocess(*args, camera_from_numpy(jcam), sh_degree=0,
                                      alive=torch.from_numpy(alive))
    np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref["valid"]))


def test_table_layout(rng):
    cam = camera_from_numpy(example_camera())
    _, args = _both(_pool(rng, 40, 3))
    o = stages.preprocess(*args, cam)
    table = preprocess.preprocess_fwd(*args, cam)
    assert table.shape == (40, preprocess.TABLE_COLS) and table.is_contiguous()
    for cols, key in ((slice(0, 2), "us"), (slice(2, 5), "cinv2ds"), (slice(6, 9), "colors"),
                      (slice(10, 12), "areas")):
        np.testing.assert_array_equal(table[:, cols].numpy(), o[key].numpy())
    np.testing.assert_array_equal(table[:, 5].numpy(), args[2].numpy())
    np.testing.assert_array_equal(table[:, 9].numpy(), o["depths"].numpy())
    vec = preprocess.camera_vector(cam)
    assert vec.shape == (preprocess.CAM_LEN,) and vec.dtype == np.float32
    np.testing.assert_array_equal(vec[12:15], cam.twc)


def test_sh_width_validation(rng):
    cam = camera_from_numpy(example_camera())
    _, args = _both(_pool(rng, 8, 3))
    with pytest.raises(ValueError, match="exceeds"):
        preprocess.preprocess_fwd(*args, cam, sh_degree=2)
    bad = list(args)
    bad[1] = args[1][:, :10].contiguous()
    with pytest.raises(ValueError, match="3\\*"):
        preprocess.preprocess_fwd(*bad, cam)
    with pytest.raises(ValueError, match="exceeds"):
        stages.sh2color(args[1], args[0], cam.twc, degree=1)


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity"])
def test_wrapper_rejects_bad_inputs(rng, case):
    cam = camera_from_numpy(example_camera())
    _, args = _both(_pool(rng, 8, 0))
    args = list(args)
    if case == "dtype":
        args[0] = args[0].double()
        err = TypeError
    elif case == "shape":
        args[4] = args[4][:, :3].contiguous()
        err = ValueError
    else:
        args[0] = torch.empty((3, 8)).t()
        err = ValueError
    with pytest.raises(err):
        preprocess.preprocess_fwd(*args, cam, sh_degree=0)


def test_plain_cpu_path_does_not_count_launches(rng):
    cam = camera_from_numpy(example_camera())
    _, args = _both(_pool(rng, 8, 0))
    before = preprocess.preprocess_fwd.launches
    preprocess.preprocess_fwd(*args, cam, sh_degree=0)
    assert preprocess.preprocess_fwd.launches == before

