"""PyTorch port: the plain version of K4 (the stage-6 wrapper on CPU tensors)
against the JAX Pallas rasteriser run through the interpreter, on the same
binning."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.data import example_camera
from easygaussiansplatting_tpu.models import Camera as JaxCamera
from easygaussiansplatting_tpu.ops import stages as jax_stages
from easygaussiansplatting_tpu.ops.binning import bin_gaussians as jax_bin
from easygaussiansplatting_tpu.ops.pallas.rasterize import rasterize_pallas
from easygaussiansplatting_tpu_torch.ops import rasterize_tiled
from easygaussiansplatting_tpu_torch.ops.kernels import preprocess, rasterize

torch.set_num_threads(2)

CAM = JaxCamera.from_dict(example_camera())
W, H = CAM.width, CAM.height


def _random_scene(rng, n=120):
    pws = rng.normal(size=(n, 3)) * np.array([1.5, 1.0, 1.5])
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    return (pws, rng.normal(size=(n, 3)) * 0.5, 1 / (1 + np.exp(-rng.normal(size=n))),
            np.exp(rng.normal(size=(n, 3)) * 0.4 - 2.2), rots)


def _stack_scene(rng, n=700):
    """An opaque stack (saturates tau, tile lists past one 256-entry batch)
    plus a spread."""
    pws = np.concatenate([rng.normal(size=(n // 2, 3)) * 0.02,
                          rng.normal(size=(n - n // 2, 3)) * np.array([1.5, 1.0, 1.5])])
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    return (pws, rng.normal(size=(n, 3)) * 0.5, np.full(n, 0.95),
            np.exp(rng.normal(size=(n, 3)) * 0.3 - 1.8), rots)


def _both(params, max_patches, k_chunk):
    """JAX stages + JAX binning, then both rasterisers on those arrays."""
    args = [jnp.asarray(a, jnp.float32) for a in params]
    aux = jax_stages.preprocess(*args, CAM, sh_degree=0)
    b = jax_bin(aux["us"], aux["depths"], aux["areas"], aux["valid"], width=W, height=H,
                max_patches=max_patches, cinv2ds=aux["cinv2ds"], alphas=aux["alphas"])
    img_j, raux_j = rasterize_pallas(aux["us"], aux["cinv2ds"], aux["alphas"], aux["colors"],
                                     b, width=W, height=H, k_chunk=k_chunk, interpret=True)
    t = {k: torch.from_numpy(np.array(aux[k])) for k in
         ("us", "cinv2ds", "alphas", "colors", "depths", "areas")}
    table = preprocess.pack_table(t["us"], t["cinv2ds"], t["alphas"], t["colors"],
                                  t["depths"], t["areas"])
    tb = {k: torch.from_numpy(np.array(b[k])) for k in ("patch_gsid", "tile_start", "tile_cnt")}
    img, tau, cont = rasterize.rasterize_fwd(table, tb["patch_gsid"], tb["tile_start"],
                                             tb["tile_cnt"], width=W, height=H)
    return (img, tau, cont), (img_j, raux_j), b


def _assert_match(got, want):
    (img, tau, cont), (img_j, raux_j) = got, want
    assert img.shape == (3, H, W) and tau.shape == cont.shape == (H, W)
    # 3e-5: the Pallas forward reduces the transmittance product with a
    # halving tree, the plain version with chunked cumulative products
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=3e-5)
    np.testing.assert_allclose(tau.numpy(), np.asarray(raux_j["final_tau"]), atol=3e-5)
    np.testing.assert_array_equal(cont.numpy(), np.asarray(raux_j["contrib"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k4_matches_pallas(seed):
    rng = np.random.default_rng(seed)
    got, want, _ = _both(_random_scene(rng), max_patches=4096, k_chunk=128)
    _assert_match(got, want)


def test_saturating_multi_batch_tile():
    rng = np.random.default_rng(0)
    got, want, b = _both(_stack_scene(rng), max_patches=4096, k_chunk=512)
    assert int(np.asarray(b["tile_cnt"]).max()) > 256  # more than one CUDA batch
    assert float(got[1].min()) < 1e-4  # saturation actually hit
    _assert_match(got, want)


def test_empty_scene():
    pws = np.array([[0.0, 0.0, -100.0]])  # behind the camera
    params = (pws, np.ones((1, 3)), np.ones(1), np.full((1, 3), 0.05),
              np.array([[1.0, 0, 0, 0]]))
    got, want, _ = _both(params, max_patches=256, k_chunk=128)
    img, tau, cont = got
    assert float(img.abs().max()) == 0.0
    assert float(tau.min()) == 1.0 and int(cont.max()) == 0
    _assert_match(got, want)


def test_chunk_size_does_not_change_the_result(rng, monkeypatch):
    """The plain version walks every chunk up to the longest tile list, so
    no chunk size truncates anything."""
    args = [jnp.asarray(a, jnp.float32) for a in _stack_scene(rng, n=400)]
    aux = jax_stages.preprocess(*args, CAM, sh_degree=0)
    b = jax_bin(aux["us"], aux["depths"], aux["areas"], aux["valid"], width=W, height=H,
                max_patches=2048)
    t = [torch.from_numpy(np.array(aux[k])) for k in ("us", "cinv2ds", "alphas", "colors")]
    tb = [torch.from_numpy(np.array(b[k])) for k in ("patch_gsid", "tile_start", "tile_cnt")]
    outs = []
    for k in (16, 64, 1024):
        monkeypatch.setattr(rasterize_tiled, "K_CHUNK", k)
        outs.append(rasterize_tiled.rasterize_tiled(*t, *tb, width=W, height=H))
    assert outs[0][1]["max_tile_cnt"] > 64
    for img, aux_k in outs[1:]:
        np.testing.assert_allclose(img.numpy(), outs[0][0].numpy(), atol=1e-6)
        np.testing.assert_array_equal(aux_k["contrib"].numpy(), outs[0][1]["contrib"].numpy())


@pytest.mark.parametrize("bad", ["table_cols", "gsid_dtype", "tile_count"])
def test_wrapper_rejects(bad):
    table = torch.zeros((4, preprocess.TABLE_COLS))
    gsid = torch.zeros(8, dtype=torch.int32)
    start = torch.zeros(2, dtype=torch.int32)
    cnt = torch.zeros(2, dtype=torch.int32)
    if bad == "table_cols":
        table = torch.zeros((4, 9))
    elif bad == "gsid_dtype":
        gsid = gsid.long()
    else:
        start = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        rasterize.rasterize_fwd(table, gsid, start, cnt, width=W, height=H)

