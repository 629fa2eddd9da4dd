"""PyTorch port: the reference rasteriser (ops/rasterize_ref.py) and the
render API's "dense" backend against the JAX package's
ops/rasterize_ref.py, forward and gradients, float32 on the CPU.

Tolerances: the image, final_tau and the five gradient groups within
2e-5 + 2e-5 * |want| (float32: both sides run the same operations in the
same order, but exp, the stages' divisions and the reverse sweep round in
different libraries); contrib exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.models import Camera as JaxCamera
from easygaussiansplatting_tpu.ops.rasterize_ref import rasterize_dense as jax_dense
from easygaussiansplatting_tpu.ops.rasterize_ref import render_reference as jax_reference
from easygaussiansplatting_tpu_torch import golden
from easygaussiansplatting_tpu_torch.data import example_camera, example_gaussians
from easygaussiansplatting_tpu_torch.models import Camera
from easygaussiansplatting_tpu_torch.ops import stages
from easygaussiansplatting_tpu_torch.ops.rasterize import render
from easygaussiansplatting_tpu_torch.ops.rasterize_ref import rasterize_dense, render_reference

KEYS = ("pws", "shs", "alphas", "scales", "rots")
ATOL = RTOL = 2e-5


def _fixture():
    gs = example_gaussians()
    gs["alphas"] = np.full(4, 0.8)
    return gs, example_camera()


def _random(n, seed, saturate=False):
    rng = np.random.default_rng(seed)
    rots = rng.normal(size=(n, 4))
    gs = {"pws": rng.normal(size=(n, 3)) * np.array([1.5, 1.0, 1.5]),
          "rots": rots / np.linalg.norm(rots, axis=1, keepdims=True),
          "scales": np.exp(rng.normal(size=(n, 3)) * 0.4 - 2.2),
          "alphas": 1 / (1 + np.exp(-rng.normal(size=n))),
          "shs": rng.normal(size=(n, 12)) * 0.5}
    if saturate:  # opaque clump: alpha' clamps at 0.99 and tau stops
        gs["pws"][: n // 2] *= 0.05
        gs["alphas"][: n // 2] = 0.995
    return gs, example_camera()


CASES = {"fixture": _fixture, "random40": lambda: _random(40, 1),
         "saturated": lambda: _random(30, 2, saturate=True)}


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=what)


def _degree(gs):
    return int(np.sqrt(gs["shs"].shape[1] // 3)) - 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_reference_matches_jax(case):
    """Image, contrib, final_tau and the gradients of sum(image * w) with
    respect to the five parameter groups."""
    gs, camd = CASES[case]()
    deg = _degree(gs)
    w = np.random.default_rng(9).normal(size=(3, camd["height"], camd["width"]))
    jcam = JaxCamera.from_dict(camd)

    def jax_loss(*p):
        img, aux = jax_reference(*p, jcam, sh_degree=deg)
        return jnp.sum(img * w), (img, aux["contrib"], aux["final_tau"])

    jargs = [jnp.asarray(gs[k], jnp.float32) for k in KEYS]
    (_, (img_j, contrib_j, tau_j)), grads_j = jax.value_and_grad(
        jax_loss, argnums=tuple(range(5)), has_aux=True)(*jargs)

    targs = [torch.tensor(np.asarray(gs[k], np.float32), requires_grad=True) for k in KEYS]
    img, aux = render_reference(*targs, Camera.from_dict(camd), sh_degree=deg)
    (img * torch.as_tensor(w, dtype=torch.float32)).sum().backward()

    _close(img, img_j, "image")
    assert np.array_equal(aux["contrib"].numpy(), np.asarray(contrib_j))
    _close(aux["final_tau"], tau_j, "final_tau")
    for k, t, g in zip(KEYS, targs, grads_j):
        _close(t.grad, g, f"d/d{k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterize_dense_matches_jax_on_the_same_attributes(case):
    """Stage 6 alone, on the port's stage 1-5 outputs fed to both sides."""
    gs, camd = CASES[case]()
    cam = Camera.from_dict(camd)
    aux = stages.preprocess(*(torch.tensor(np.asarray(gs[k], np.float32)) for k in KEYS), cam,
                            sh_degree=_degree(gs))
    names = ("us", "cinv2ds", "alphas", "colors", "depths", "areas", "valid")
    got = rasterize_dense(*(aux[k] for k in names), width=cam.width, height=cam.height)
    want = jax_dense(*(jnp.asarray(aux[k].numpy()) for k in names), width=cam.width,
                     height=cam.height)
    _close(got[0], want[0], "image")
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[2], want[2], "final_tau")


def test_dense_backend_is_render_reference_and_matches_golden():
    """render(backend="dense") is render_reference (bit-equal, us_offset
    zeros included), and its fixture image is the float64 oracle's within
    5e-3 with contrib equal (the bound of the JAX package's own test)."""
    gs, camd = _fixture()
    cam = Camera.from_dict(camd)
    img, aux = render(*(gs[k] for k in KEYS), cam, sh_degree=0, backend="dense", device="cpu",
                      us_offset=torch.zeros(4, 2))
    ref, raux = render_reference(*(torch.tensor(np.asarray(gs[k], np.float32)) for k in KEYS),
                                 cam, sh_degree=0)
    assert torch.equal(img, ref) and torch.equal(aux["contrib"], raux["contrib"])
    assert set(raux) <= set(aux)
    img_g, aux_g = golden.render(*(gs[k] for k in KEYS), camd["Rcw"], camd["tcw"], camd["fx"],
                                 camd["fy"], camd["cx"], camd["cy"], camd["width"],
                                 camd["height"])
    np.testing.assert_allclose(img.detach().numpy(), img_g, atol=5e-3)
    assert np.array_equal(aux["contrib"].numpy(), aux_g["contrib"])


def test_dense_backend_matches_tiled_backend():
    """The two plain backends on one random scene: images within 1e-5 and
    contrib equal."""
    gs, camd = _random(60, 4)
    kw = dict(sh_degree=1, device="cpu", need_grads=False)
    a, aux_a = render(*(gs[k] for k in KEYS), Camera.from_dict(camd), backend="dense", **kw)
    b, aux_b = render(*(gs[k] for k in KEYS), Camera.from_dict(camd), backend="tiled", **kw)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert torch.equal(aux_a["contrib"], aux_b["contrib"])
