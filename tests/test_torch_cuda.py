"""PyTorch port on the card: each CUDA kernel against its plain version, and
the kernel render path against the all-plain path. Every test here needs a
CUDA device and nvcc, and skips without one.

The file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu_torch.data import example_camera
from easygaussiansplatting_tpu_torch.models import Camera
from easygaussiansplatting_tpu_torch.models.convert import gaussians_from_numpy
from easygaussiansplatting_tpu_torch.ops.binning import bin_gaussians
from easygaussiansplatting_tpu_torch.ops.kernels import preprocess, rasterize, scan
from easygaussiansplatting_tpu_torch.ops.rasterize import raster_from_aux, render

pytestmark = pytest.mark.cuda

KEYS = ("pws", "shs", "alphas", "scales", "rots")
CAM = Camera.from_dict(example_camera())


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled with nvcc on the card")
    return torch.device("cuda")


def _scene(seed, n, deg=3, stack=False):
    rng = np.random.default_rng(seed)
    pws = rng.normal(size=(n, 3)) * np.array([1.5, 1.0, 1.5])
    if stack:  # an opaque clump: saturation and tile lists past one batch
        pws[: n // 2] = rng.normal(size=(n // 2, 3)) * 0.02
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    return {"pws": pws, "rots": rots,
            "scales": np.exp(rng.normal(size=(n, 3)) * 0.4 - 2.2),
            "alphas": np.full(n, 0.95) if stack else 1 / (1 + np.exp(-rng.normal(size=n))),
            "shs": rng.normal(size=(n, 3 * (deg + 1) ** 2)) * 0.3}


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4, 5])
def test_preprocess_kernel_matches_plain(cuda, deg):
    t = gaussians_from_numpy(_scene(0, 3000, deg), cuda)
    args = [t[k] for k in KEYS]
    got = preprocess.preprocess_fwd(*args, CAM, sh_degree=deg)
    want = preprocess.preprocess_plain(*args, CAM, sh_degree=deg)
    torch.testing.assert_close(got[:, :10], want[:, :10], atol=2e-5, rtol=2e-5)
    assert float((got[:, 10:] != want[:, 10:]).float().mean()) < 1e-3


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("m", [1, 2047, 2048, 2049, 557056])
def test_scan_kernel_matches_cumsum(cuda, dtype, m):
    g = torch.Generator().manual_seed(m)
    x = torch.randint(-9, 9, (3, m), generator=g).to(dtype).to(cuda)
    got = scan.multi_cumsum(x)
    assert got.dtype == dtype
    want = torch.cumsum(x, 1, dtype=dtype)
    if dtype == torch.int32:
        assert torch.equal(got, want)
    else:  # small integers: every partial sum is exact in float32
        torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("stack", [False, True])
def test_rasterize_kernel_matches_plain(cuda, stack):
    t = gaussians_from_numpy(_scene(1, 700, 0, stack=stack), cuda)
    pre = preprocess.fused_preprocess(*(t[k] for k in KEYS), CAM, sh_degree=0)
    b = bin_gaussians(pre["us"], pre["depths"], pre["areas"], pre["valid"], width=CAM.width,
                      height=CAM.height, max_patches=8192, cinv2ds=pre["cinv2ds"],
                      alphas=pre["alphas"])
    args = (pre["table"], b["patch_gsid"], b["tile_start"], b["tile_cnt"])
    got = rasterize.rasterize_fwd(*args, width=CAM.width, height=CAM.height)
    want = rasterize.rasterize_plain(*args, width=CAM.width, height=CAM.height)
    if stack:
        assert int(b["tile_cnt"].max()) > 256 and float(got[1].min()) < 1e-4
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)
    assert float((got[2] != want[2]).float().mean()) <= 1e-4


def test_render_kernel_path_matches_plain_path(cuda):
    g = _scene(2, 2000)
    counts = [w.launches for w in (preprocess.preprocess_fwd, scan.multi_cumsum,
                                   rasterize.rasterize_fwd)]
    img, aux = render(*(g[k] for k in KEYS), CAM, max_patches=8192)
    after = [w.launches for w in (preprocess.preprocess_fwd, scan.multi_cumsum,
                                  rasterize.rasterize_fwd)]
    assert [a - b for a, b in zip(after, counts)] == [1, 3, 1]
    img_p, aux_p = render(*(g[k] for k in KEYS), CAM, max_patches=8192, backend="tiled")
    torch.testing.assert_close(img, img_p, atol=1e-4, rtol=0)
    for k in ("patch_gsid", "tile_start", "tile_cnt", "total"):
        assert torch.equal(aux["binning"][k], aux_p["binning"][k]), k


def test_raster_from_aux_needs_the_table_on_the_kernel_path(cuda):
    t = gaussians_from_numpy(_scene(3, 50, 0), cuda)
    pre = preprocess.fused_preprocess(*(t[k] for k in KEYS), CAM, sh_degree=0)
    attrs = [pre[k] for k in ("us", "cinv2ds", "alphas", "colors", "depths", "areas", "valid")]
    with pytest.raises(ValueError, match="table"):
        raster_from_aux(*attrs, width=CAM.width, height=CAM.height, max_patches=1024)
