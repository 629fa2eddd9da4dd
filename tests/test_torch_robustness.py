"""PyTorch port on degenerate inputs: no NaNs in images or gradients.

The scenes and assertions of the JAX package's tests/test_robustness.py,
through the port's plain paths ("tiled" and "dense" on the CPU): a
singular conic (scales 1e-12), a giant splat (scales 50), an extremely
anisotropic gaussian, alphas of 1e-8 and 1.0, a point far behind the
camera, and a training scene whose every gaussian is culled. The image is
also held to the JAX package's tiled render of the same scene within 1e-5.
tests/test_torch_cuda.py runs the same scenes through K1, K2, K4 and K5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.models import Camera as JaxCamera
from easygaussiansplatting_tpu.ops.rasterize import render as jax_render
from easygaussiansplatting_tpu_torch.data import example_camera
from easygaussiansplatting_tpu_torch.data.fixtures import culled_scene, degenerate_scene
from easygaussiansplatting_tpu_torch.models import Camera
from easygaussiansplatting_tpu_torch.ops.rasterize import render

NAMES = ("pws", "shs", "alphas", "scales", "rots")
KW = dict(max_patches=4096, sh_degree=0, device="cpu")


@pytest.mark.parametrize("backend", ["tiled", "dense"])
def test_no_nans_in_image_or_grads(backend):
    cam = Camera.from_dict(example_camera())
    args = [torch.tensor(a, requires_grad=True) for a in degenerate_scene()]
    img, aux = render(*args, cam, backend=backend, **KW)
    assert torch.isfinite(img).all() and torch.isfinite(aux["final_tau"]).all()
    (img ** 2).sum().backward()
    for t, name in zip(args, NAMES):
        assert torch.isfinite(t.grad).all(), f"non-finite grad {name} ({backend})"
    want, _ = jax_render(*(jnp.asarray(a) for a in degenerate_scene()),
                         JaxCamera.from_dict(example_camera()), backend="tiled",
                         max_patches=4096, sh_degree=0)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("backend", ["tiled", "dense"])
def test_all_culled_scene_trains(backend):
    """Every gaussian behind the camera: zero image, zero grads, no NaNs."""
    cam = Camera.from_dict(example_camera())
    pws, shs, alphas, scales, rots = (torch.tensor(a) for a in culled_scene())
    pws.requires_grad_(True)
    img, _ = render(pws, shs, alphas, scales, rots, cam, backend=backend, **KW)
    img.sum().backward()
    assert float(img.detach().abs().max()) == 0.0
    assert float(pws.grad.abs().max()) == 0.0 and torch.isfinite(pws.grad).all()
    g = jax.grad(lambda p: jax_render(
        p, *(jnp.asarray(a) for a in culled_scene()[1:]), JaxCamera.from_dict(example_camera()),
        backend="tiled", max_patches=4096, sh_degree=0)[0].sum())(jnp.asarray(culled_scene()[0]))
    assert float(jnp.abs(g).max()) == 0.0
