"""PyTorch port: SH basis, camera, fixtures, synthetic scenes, gaussian I/O,
PSNR and the numpy -> tensor conversions, against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.data import example_camera as jax_example_camera
from easygaussiansplatting_tpu.data import example_gaussians as jax_example_gaussians
from easygaussiansplatting_tpu.data.gau_io import arrays_to_recarray, save_gs
from easygaussiansplatting_tpu.data.gau_io import load_gs as jax_load_gs
from easygaussiansplatting_tpu.data.synthetic import make_synthetic_scene as jax_scene
from easygaussiansplatting_tpu.models import Camera as JaxCamera
from easygaussiansplatting_tpu.utils import sh as jax_sh
from easygaussiansplatting_tpu.utils.image import psnr as jax_psnr
from easygaussiansplatting_tpu_torch.data import example_camera, example_gaussians
from easygaussiansplatting_tpu_torch.data.gau_io import load_gs, recarray_to_arrays
from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene
from easygaussiansplatting_tpu_torch.models import Camera
from easygaussiansplatting_tpu_torch.models.convert import camera_from_numpy, gaussians_from_numpy
from easygaussiansplatting_tpu_torch.utils import sh
from easygaussiansplatting_tpu_torch.utils.device import resolve_device
from easygaussiansplatting_tpu_torch.utils.image import psnr, save_png, to_uint8

torch.set_num_threads(2)


def _unit_dirs(rng, n=257):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4, 5])
def test_sh_basis_matches_jax(rng, degree):
    d = _unit_dirs(rng)
    want = jax_sh.sh_basis(jnp, *(jnp.asarray(d[:, i]) for i in range(3)), degree)
    got = sh.sh_basis(torch, *(torch.from_numpy(d[:, i].copy()) for i in range(3)), degree)
    assert len(got) == len(want) == (degree + 1) ** 2
    for g, w in zip(got, want):
        # same float32 expressions in the same order: equal up to XLA's
        # freedom to contract multiply-adds
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_sh_constants_match_jax():
    for name in ("SH_C0", "SH_C1", "SH_C2", "SH_C3", "SH_C4", "SH_C5"):
        assert getattr(sh, name) == getattr(jax_sh, name)
    assert len(sh.SH_CONSTS) == 36
    assert sh.num_sh_bases(3) == jax_sh.num_sh_bases(3) == 16


def test_camera_twc_matches_jax():
    jc = JaxCamera.from_dict(jax_example_camera())
    tc = Camera.from_dict(example_camera())
    np.testing.assert_array_equal(tc.twc, np.asarray(jc.twc))
    assert tc.twc.dtype == np.float32
    assert (tc.width, tc.height) == (jc.width, jc.height)


def test_fixtures_bit_equal():
    a, b = example_gaussians(), jax_example_gaussians()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    ca, cb = example_camera(), jax_example_camera()
    for k in ca:
        np.testing.assert_array_equal(np.asarray(ca[k]), np.asarray(cb[k]))


def test_synthetic_scene_bit_equal():
    kw = dict(seed=3, n_gaussians=50, n_cams=3, width=40, height=30, log_scale_mean=-3.0)
    a, b = make_synthetic_scene(**kw), jax_scene(**kw)
    for k in ("pws", "rots", "scales", "alphas", "shs"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["scene_size"] == b["scene_size"]
    for ca, cb in zip(a["cameras"], b["cameras"]):
        for k in ("Rcw", "tcw", "fx", "fy", "cx", "cy"):
            np.testing.assert_array_equal(getattr(ca, k), np.asarray(getattr(cb, k)))
        assert (ca.width, ca.height, ca.id) == (cb.width, cb.height, cb.id)


@pytest.mark.parametrize("ext", [".npy", ".ply"])
def test_load_files_written_by_jax_package(rng, tmp_path, ext):
    n, sh_dim = 11, 48
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    gs = arrays_to_recarray(
        rng.normal(size=(n, 3)), rots, np.exp(rng.normal(size=(n, 3)) - 2),
        rng.uniform(0.1, 0.9, size=n), rng.normal(size=(n, sh_dim)),
    )
    path = tmp_path / f"g{ext}"
    save_gs(path, gs)
    got = recarray_to_arrays(load_gs(path))
    want = jax_load_gs(path)
    for k, field in (("pws", "pw"), ("rots", "rot"), ("scales", "scale"),
                     ("alphas", "alpha"), ("shs", "sh")):
        np.testing.assert_array_equal(got[k], np.asarray(want[field], np.float32))
    assert got["shs"].shape == (n, sh_dim)


def test_load_gs_rejects_unknown_extension(tmp_path):
    with pytest.raises(ValueError):
        load_gs(tmp_path / "g.txt")


def test_gaussians_from_numpy():
    g = jax_example_gaussians()
    t = gaussians_from_numpy(g, device="cpu")
    for k in ("pws", "shs", "alphas", "scales", "rots"):
        assert t[k].dtype == torch.float32 and t[k].is_contiguous()
        np.testing.assert_array_equal(t[k].numpy(), g[k].astype(np.float32))
    t2 = gaussians_from_numpy({**g, "alphas": g["alphas"][:, None],
                               "shs": g["shs"].reshape(4, 1, 3)}, device="cpu")
    assert t2["alphas"].shape == (4,) and t2["shs"].shape == (4, 3)


def test_camera_from_numpy_jax_camera_and_dict():
    jc = JaxCamera.from_dict(jax_example_camera())
    for src in (jc, jax_example_camera()):
        tc = camera_from_numpy(src)
        for k in ("Rcw", "tcw", "fx", "fy", "cx", "cy"):
            np.testing.assert_array_equal(getattr(tc, k), np.asarray(getattr(jc, k)))
        assert (tc.width, tc.height) == (jc.width, jc.height)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()
        with pytest.raises(RuntimeError):
            gaussians_from_numpy(jax_example_gaussians())


def test_save_png_roundtrip(tmp_path):
    from PIL import Image

    img = np.random.default_rng(0).uniform(-0.2, 1.2, size=(3, 5, 7)).astype(np.float32)
    rgb = to_uint8(img)
    save_png(tmp_path / "a.png", rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), rgb)


@pytest.mark.parametrize("max_val", [1.0, 255.0])
def test_psnr_matches_jax(rng, max_val):
    img = (rng.random((3, 24, 32)) * max_val).astype(np.float32)
    ref = np.clip(img + rng.normal(scale=0.05 * max_val, size=img.shape), 0, max_val)
    ref = ref.astype(np.float32)
    want = float(jax_psnr(jnp.asarray(img), jnp.asarray(ref), max_val=max_val))
    got = float(psnr(torch.from_numpy(img), torch.from_numpy(ref), max_val=max_val))
    np.testing.assert_allclose(got, want, rtol=1e-6)
