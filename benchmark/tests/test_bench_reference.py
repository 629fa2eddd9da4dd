"""The yardstick held to the program's plain paths on the CPU at tiny sizes:
the reference render and its gradients against ``ops/rasterize_ref.py``
and the float64 oracle ``golden/``, the reference loss against
``ops/loss.py``, the frozen JPEG encoder's bytes against ``utils/jpeg.py``,
and the decoder against the encoder. The reference itself imports none of
these; only this test does."""

import numpy as np
import pytest
import torch

from benchmark import scene as bscene
from benchmark.reference import jpeg, jpeg_decode
from benchmark.reference import render as ref_render
from benchmark.reference import train as ref_train
from easygaussiansplatting_tpu_torch import golden
from easygaussiansplatting_tpu_torch.data.fixtures import example_camera, example_gaussians
from easygaussiansplatting_tpu_torch.models.camera import Camera
from easygaussiansplatting_tpu_torch.ops import loss as port_loss
from easygaussiansplatting_tpu_torch.ops.rasterize_ref import render_reference
from easygaussiansplatting_tpu_torch.utils import jpeg as port_jpeg


def small_scene(seed=3, n=60, width=40, height=24, deg3=True):
    sc = bscene.synthetic_scene(seed, n, 3, width, height, log_scale_mean=-2.2)
    rng = np.random.default_rng(seed)
    shs = np.concatenate([sc["shs"], rng.normal(size=(n, 45)) * 0.2], 1) if deg3 else sc["shs"]
    params = {"pws": sc["pws"], "shs": shs, "alphas": sc["alphas"], "scales": sc["scales"],
              "rots": sc["rots"]}
    return params, sc["cameras"]


def as_tensors(params, dtype, grad=False):
    return {k: torch.tensor(np.asarray(v), dtype=dtype, requires_grad=grad)
            for k, v in params.items()}


@pytest.mark.parametrize("seed", [3, 4])
def test_render_equals_the_float64_oracle(seed):
    params, cams = small_scene(seed)
    for cam in cams:
        want, _ = golden.render(params["pws"], params["shs"], params["alphas"], params["scales"],
                                params["rots"], cam["Rcw"].astype(np.float64),
                                cam["tcw"].astype(np.float64), float(cam["fx"]),
                                float(cam["fy"]), float(cam["cx"]), float(cam["cy"]),
                                cam["width"], cam["height"])
        got = ref_render.render(as_tensors(params, torch.float64), cam)
        assert np.abs(got.numpy() - want).max() < 1e-9


def test_render_equals_the_oracle_on_the_fixture():
    gs, cam = example_gaussians(), example_camera()
    want, _ = golden.render(gs["pws"], gs["shs"], gs["alphas"], gs["scales"], gs["rots"],
                            cam["Rcw"], cam["tcw"], cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                            cam["width"], cam["height"])
    got = ref_render.render(as_tensors(gs, torch.float64), cam)
    assert np.abs(got.numpy() - want).max() < 1e-9
    assert want.max() > 0.1  # the fixture draws something


def test_render_and_gradients_equal_the_programs_dense_reference():
    params, cams = small_scene(5)
    cam = cams[1]
    target = torch.rand((3, cam["height"], cam["width"]),
                        generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    mine = as_tensors(params, torch.float64, grad=True)
    loss, image = ref_render.render_grad(mine, cam, lambda img: ((img - target) ** 2).sum())
    theirs = as_tensors(params, torch.float64, grad=True)
    want, _ = render_reference(*(theirs[k] for k in ("pws", "shs", "alphas", "scales", "rots")),
                               Camera.from_dict(cam, np.float64))
    ((want - target) ** 2).sum().backward()
    assert torch.allclose(image, want.detach(), atol=1e-10)
    # the program rounds 1.3 tan(fov/2) to float32 even in float64, which
    # moves the gradients of gaussians clamped at the field of view by
    # ~1e-8 of the largest
    for k in mine:
        scale = float(theirs[k].grad.abs().max())
        assert scale > 0
        assert float((mine[k].grad - theirs[k].grad).abs().max()) <= 1e-6 * scale, k


def test_loss_equals_the_programs():
    g = torch.Generator().manual_seed(1)
    a, b = torch.rand((3, 40, 56), generator=g), torch.rand((3, 40, 56), generator=g)
    want = port_loss.gau_loss(a, b, 0.2)
    assert float(ref_train.loss_fn(a, b)) == pytest.approx(float(want), rel=1e-5)
    mine, theirs = a.clone().requires_grad_(True), a.clone().requires_grad_(True)
    ref_train.loss_fn(mine, b).backward()
    port_loss.gau_loss(theirs, b, 0.2).backward()
    # float32: separable convolutions against the program's band matrices
    assert float((mine.grad - theirs.grad).abs().max()) <= 1e-4 * float(theirs.grad.abs().max())


@pytest.mark.parametrize("size", [(136, 244), (48, 80), (17, 33)])
def test_frozen_jpeg_equals_the_programs_plain_encoder(size):
    h, w = size
    g = torch.Generator().manual_seed(h)
    frame = (torch.rand((h, w, 3), generator=g) * 255).to(torch.uint8)
    frame = torch.cumsum(frame.int(), dim=1).remainder(256).to(torch.uint8)
    assert jpeg.encode_jpeg_plain(frame, 90) == port_jpeg.encode_jpeg_plain(frame, 90)
    body = jpeg.encode_jpeg_plain(frame, 90)
    got = jpeg_decode.coefficients(body, w, h, 90)
    assert np.array_equal(got, jpeg.coefficients(frame, 90).numpy())


def test_decoder_refuses_what_is_not_the_encoders():
    frame = torch.zeros((16, 16, 3), dtype=torch.uint8)
    body = jpeg.encode_jpeg_plain(frame, 90)
    with pytest.raises(jpeg_decode.JpegError):
        jpeg_decode.coefficients(body, 16, 32, 90)  # another size
    with pytest.raises(jpeg_decode.JpegError):
        jpeg_decode.coefficients(body[:-2], 16, 16, 90)  # no EOI
    with pytest.raises(jpeg_decode.JpegError):
        jpeg_decode.coefficients(jpeg.encode_jpeg_plain(frame, 80), 16, 16, 90)
