"""PyTorch port on the card: each CUDA kernel against its plain version, the
kernel render path against the all-plain path, the kernel training step
against the all-plain step, degenerate scenes through the kernels, and
the photo path (nvJPEG within its limits of PIL's decode, the resize and
the PNG decoder bit-equal to PIL) against the committed fixture archive.
Every test here needs a CUDA device and nvcc, and skips without one.

The file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu_torch.data import example_camera, image_io
from easygaussiansplatting_tpu_torch.data.dataset import load_image
from easygaussiansplatting_tpu_torch.data.fixtures import (
    PRE_BLOCK,
    PRE_EDGES,
    SCAN_CASES,
    SCAN_TILE,
    SEG_CASES,
    SEG_TILE,
    culled_scene,
    degenerate_scene,
    preprocess_case,
    scan_case,
    segment_case,
    stacked_tile,
)
from easygaussiansplatting_tpu_torch.data.make_io_fixtures import (
    FIXTURES,
    JPEGS,
    PNGS,
    RATES,
    planted_faults,
)
from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene
from easygaussiansplatting_tpu_torch.models import Camera
from easygaussiansplatting_tpu_torch.models.convert import gaussians_from_numpy
from easygaussiansplatting_tpu_torch.models.gaussians import pool_from_arrays
from easygaussiansplatting_tpu_torch.ops import stages
from easygaussiansplatting_tpu_torch.ops.binning import bin_gaussians
from easygaussiansplatting_tpu_torch.ops.kernels import preprocess, radix, rasterize, scan, sort
from easygaussiansplatting_tpu_torch.ops.rasterize import raster_from_aux, render
from easygaussiansplatting_tpu_torch.probes import exp_dma_stream, micro_bench
from easygaussiansplatting_tpu_torch.train.config import TrainConfig
from easygaussiansplatting_tpu_torch.train.loop import loss_and_grads

pytestmark = pytest.mark.cuda

KEYS = ("pws", "shs", "alphas", "scales", "rots")
CAM = Camera.from_dict(example_camera())
PROFILE_TRIES = 3


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
@pytest.mark.parametrize("m", [1, 2047, 2048, 2049, 557056, 2**21, 2**24])
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


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("n", PRE_EDGES + (65537,))
def test_preprocess_kernel_at_block_edges(cuda, n, deg):
    """N at and around the kernel's 128-gaussian blocks
    (data/fixtures.py::preprocess_case, a fifth behind the camera): the
    float columns within 2e-5 of the plain version's (abs or rel), the
    extents equal except where the pre-ceil value lies within 1e-4 of an
    integer, and two calls bit-equal."""
    t = {k: torch.from_numpy(v).to(cuda) for k, v in preprocess_case(n, deg, seed=n).items()}
    args = [t[k] for k in KEYS]
    got = _kernel_twice(preprocess.preprocess_fwd, *args, CAM, sh_degree=deg)
    want = preprocess.preprocess_plain(*args, CAM, sh_degree=deg)
    torch.testing.assert_close(got[:, :10], want[:, :10], atol=2e-5, rtol=2e-5)
    pre_ceil = 3.0 * torch.sqrt(torch.abs(
        stages.preprocess(*args, CAM, sh_degree=deg)["cov2ds"][:, [0, 2]]))
    near_int = (pre_ceil - torch.round(pre_ceil)).abs() < 1e-4
    assert bool(((got[:, 10:] == want[:, 10:]) | near_int).all())


def test_preprocess_kernel_needs_16_byte_alignment(cuda):
    """The kernel stages 16 bytes at a time: a contiguous view that starts
    4 bytes into its storage is refused, for the SH rows and for the
    opacities alike."""
    t = {k: torch.from_numpy(v).to(cuda) for k, v in preprocess_case(64, 3).items()}
    for name in ("shs", "alphas"):
        good = t[name]
        bad = torch.empty(good.numel() + 1, device=cuda)[1:].view(good.shape)
        bad.copy_(good)
        args = [bad if k == name else t[k] for k in KEYS]
        with pytest.raises(ValueError, match="16-byte aligned"):
            preprocess.preprocess_fwd(*args, CAM, sh_degree=3)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4, 5])
def test_preprocess_kernel_info(cuda, deg):
    """K1 spills nothing, and at degree 3 the step's 65,536 gaussians (512
    blocks) run in one wave on the card's SMs, the driver's 131,072 in at
    most two."""
    info = preprocess.kernel_info("fwd", deg)
    assert info["local_bytes"] == 0, info
    assert info["threads"] == PRE_BLOCK and info["blocks_per_sm"] >= 1, info
    if deg == 3:
        wave = info["blocks_per_sm"] * torch.cuda.get_device_properties(0).multi_processor_count
        assert wave * PRE_BLOCK >= 65536 and 2 * wave * PRE_BLOCK >= 131072, info


@pytest.mark.parametrize("rows", [1, 2, 5, 8])
@pytest.mark.parametrize("kind", SCAN_CASES)
def test_scan_kernel_at_tile_edges(cuda, kind, rows):
    """K3 at its tile edges (data/fixtures.py::scan_case: the tile and one
    off it, several tiles, int32 sums wrapping across tile boundaries, m %
    4 != 0 with row 1 unaligned): equal to torch.cumsum in int32."""
    x = torch.from_numpy(scan_case(kind, rows)).to(cuda)
    assert torch.equal(scan.multi_cumsum(x), torch.cumsum(x, 1, dtype=torch.int32))


@pytest.mark.parametrize("kind", [k for k in SCAN_CASES if k != "wrap"] + ["bench", "long"])
def test_scan_kernel_float32_bit_equal(cuda, kind):
    """K3 in float32, at its tile edges, at binning's largest call and on
    one row of 4,096 tiles: two calls bit-equal (the look-back folds the
    carry in one order), within 1e-5 of the running sum of |x| of
    torch.cumsum."""
    if kind in ("bench", "long"):
        shape = (2, 557056) if kind == "bench" else (1, 2**24)
        x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    else:
        x = torch.from_numpy(scan_case(kind, rows=3, dtype=np.float32))
    got = _kernel_twice(scan.multi_cumsum, x.to(cuda)).cpu()
    mag = torch.cumsum(x.double().abs(), 1)
    assert bool(((got.double() - torch.cumsum(x.double(), 1)).abs() <= 1e-5 * mag).all())


@pytest.mark.parametrize("m,rows", [(1, 1), (SCAN_TILE, 1), (SCAN_TILE + 1, 2), (229376, 2),
                                    (557056, 2), (3 * SCAN_TILE + 17, 8)])
def test_scan_plan(cuda, m, rows):
    """egs_multi_cumsum_plan: tiles of SCAN_TILE positions of one row, one
    launch and one memset a call; scratch of a counter (two words) and a
    64-bit status word a tile. The wrapper's call launches one kernel
    (profiled), and the C entry refuses one word less."""
    plan = scan.multi_cumsum_plan(m, rows)
    tiles = rows * -(-m // SCAN_TILE)
    assert plan == {"tile": SCAN_TILE, "launches": 1, "memsets": 1, "scratch": 2 + 2 * tiles}
    x = torch.ones((rows, m), dtype=torch.int32, device=cuda)
    scan.multi_cumsum(x)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        scan.multi_cumsum(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("multi_scan_kernel" in n for n in names) == 1, names
    out = torch.empty_like(x)
    lib = scan._build.library()
    for words, code_ok in ((plan["scratch"], True), (plan["scratch"] - 1, False)):
        scratch = torch.empty(words, dtype=torch.int32, device=cuda)
        code = lib.egs_multi_cumsum_i32(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), words,
                                        rows, m, torch.cuda.current_stream().cuda_stream)
        assert (code == 0) == code_ok
    torch.cuda.synchronize()
    assert torch.equal(scan.multi_cumsum(x), torch.cumsum(x, 1, dtype=torch.int32))


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


def _close_per_group(got, want, name):
    """atol 5e-4 * max(1, max|want|): float32 sums in another order."""
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=5e-4 * scale, rtol=0, msg=name)


def _close_to_scale(got, want, name, rel):
    """atol rel * max|want| (at least 1e-12): for the gradients of a loss that
    is a mean over pixels, which lie far below 1, where a limit relative to 1
    could not fail."""
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=max(rel * scale, 1e-12), rtol=0, msg=name)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4, 5])
def test_preprocess_bwd_kernel_matches_plain(cuda, deg):
    t = gaussians_from_numpy(_scene(4, 3000, deg), cuda)
    args = [t[k] for k in KEYS]
    g = torch.Generator().manual_seed(deg)
    dtable = torch.randn((3000, preprocess.TABLE_COLS), generator=g).to(cuda)
    got = preprocess.preprocess_bwd(*args, dtable, CAM, sh_degree=deg)
    want = preprocess.preprocess_bwd_plain(*args, dtable, CAM, sh_degree=deg)
    for a, b, name in zip(got, want, KEYS):
        assert bool(torch.isfinite(a).all()), name
        _close_per_group(a, b, name)


@pytest.mark.parametrize("m", [1, 2047, 2048, 2049, 6000, 557056])
def test_segmented_scan_kernel_matches_plain(cuda, m):
    g = torch.Generator().manual_seed(m)
    vals = torch.randn((9, m), generator=g)
    flags = (torch.rand(m, generator=g) < 0.05).to(torch.int32)
    if m == 6000:  # starts at and next to the block edges; one segment spans two blocks
        flags.zero_()
        flags[[0, 2047, 2048, 4100]] = 1
    got = scan.segmented_cumsum(vals.to(cuda), flags.to(cuda)).cpu()
    want = scan.segmented_cumsum_plain(vals, flags)
    # float32 running sums in another order: 1e-5 of the running |sum|
    mag = scan.segmented_cumsum_plain(vals.abs(), flags)
    assert bool(((got - want).abs() <= 1e-5 * mag + 1e-6).all())


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("n", [1, PRE_BLOCK - 1, PRE_BLOCK + 1, 3001])
def test_preprocess_bwd_kernel_at_block_edges(cuda, n, deg):
    """N at and around the kernel's blocks (the last block partial), each
    group within 1e-4 of its max|want| (float32 sums in another order than
    autograd's), finite, and two calls bit-equal."""
    t = gaussians_from_numpy(_scene(n, n, deg), cuda)
    args = [t[k] for k in KEYS]
    g = torch.Generator().manual_seed(n + deg)
    dtable = torch.randn((n, preprocess.TABLE_COLS), generator=g).to(cuda)
    got = _kernel_twice(preprocess.preprocess_bwd, *args, dtable, CAM, sh_degree=deg)
    want = preprocess.preprocess_bwd_plain(*args, dtable, CAM, sh_degree=deg)
    for a, b, name in zip(got, want, KEYS):
        assert bool(torch.isfinite(a).all()), name
        _close_to_scale(a, b, name, 1e-4)


@pytest.mark.parametrize("deg", [0, 3, 5])
def test_preprocess_bwd_kernel_zero_behind_the_camera(cuda, deg):
    """tests/test_torch_preprocess_bwd.py's test_invalid_gaussians_get_zero_not_nan
    on the card: a zero cotangent on the gaussians behind the camera gives
    finite gradients everywhere and exact zeros there."""
    s = _scene(8, 3001, deg)
    s["pws"][:600, 2] = np.random.default_rng(8).uniform(-10.0, -8.0, size=600)
    t = gaussians_from_numpy(s, cuda)
    args = [t[k] for k in KEYS]
    behind = preprocess.preprocess_plain(*args, CAM, sh_degree=deg)[:, 9] < 0.2
    assert int(behind.sum()) >= 600
    dtable = torch.randn((3001, preprocess.TABLE_COLS),
                         generator=torch.Generator().manual_seed(8)).to(cuda)
    dtable[behind] = 0.0
    for grad in preprocess.preprocess_bwd(*args, dtable, CAM, sh_degree=deg):
        assert bool(torch.isfinite(grad).all())
        assert bool((grad[behind] == 0).all())


def test_preprocess_bwd_kernel_needs_16_byte_alignment(cuda):
    """The kernel moves 16 bytes at a time: a contiguous view that starts
    4 bytes into its storage is refused."""
    t = gaussians_from_numpy(_scene(9, 64, 3), cuda)
    args = [t[k] for k in KEYS]
    buf = torch.empty(64 * 48 + 1, device=cuda)[1:].view(64, 48)
    buf.copy_(args[1])
    dtable = torch.zeros((64, preprocess.TABLE_COLS), device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        preprocess.preprocess_bwd(args[0], buf, *args[2:], dtable, CAM, sh_degree=3)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4, 5])
def test_preprocess_bwd_kernel_info(cuda, deg):
    """K2 spills nothing at any degree, and at degree 3 the step's 65,536
    gaussians (512 blocks) fit on the card's SMs in one wave."""
    info = preprocess.kernel_info("bwd", deg)
    assert info["local_bytes"] == 0, info
    assert info["threads"] == PRE_BLOCK and info["blocks_per_sm"] >= 1, info
    if deg == 3:
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        assert info["blocks_per_sm"] * n_sm * PRE_BLOCK >= 65536, info


@pytest.mark.parametrize("rows", [1, 9, 17])
@pytest.mark.parametrize("kind", SEG_CASES)
def test_segmented_scan_kernel_at_tile_edges(cuda, kind, rows):
    """The edges of K6's tiles (data/fixtures.py::segment_case), kernel
    against plain within 1e-5 of the running |sum|; two calls bit-equal
    (the chained carry runs its adds in one order), also across the segment
    over three tiles and past one launch's 16 rows."""
    vals, flags = (torch.from_numpy(a) for a in segment_case(kind, rows=rows))
    got = _kernel_twice(scan.segmented_cumsum, vals.to(cuda), flags.to(cuda))
    want = scan.segmented_cumsum_plain(vals, flags)
    mag = scan.segmented_cumsum_plain(vals.abs(), flags)
    assert bool(((got.cpu() - want).abs() <= 1e-5 * mag + 1e-6).all())
    if kind == "every_position":
        assert torch.equal(got.cpu(), vals)


@pytest.mark.parametrize("m,rows", [(1, 1), (SEG_TILE, 9), (SEG_TILE + 1, 9), (557056, 9),
                                    (5000, 16), (5000, 17), (5000, 33)])
def test_segmented_scan_plan(cuda, m, rows):
    """egs_segmented_cumsum_plan: tiles of SEG_TILE positions, one launch a
    group of 16 rows, one memset; scratch of a counter and a status word a
    tile a group and two values a tile a row. The wrapper's call launches
    that many kernels (profiled), and the C entry refuses one word less."""
    plan = scan.segmented_cumsum_plan(m, rows)
    tiles, groups = -(-m // SEG_TILE), -(-rows // 16)
    assert plan == {"tile": SEG_TILE, "launches": groups, "memsets": 1,
                    "scratch": groups * (1 + tiles) + 2 * tiles * rows}
    vals = torch.randn((rows, m), device=cuda)
    flags = torch.zeros(m, dtype=torch.int32, device=cuda)
    scan.segmented_cumsum(vals, flags)
    torch.cuda.synchronize()
    # a profile window can record no device event at all (the profiler's
    # lost records); such a window is taken again, up to PROFILE_TRIES, as
    # chip_smoke.py's require_kernel_count does. A window that recorded
    # events must hold the plan's kernels.
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            scan.segmented_cumsum(vals, flags)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert sum("seg_scan_kernel" in n for n in names) == groups, names
    out = torch.empty_like(vals)
    lib = scan._build.library()
    for words, code_ok in ((plan["scratch"], True), (plan["scratch"] - 1, False)):
        scratch = torch.empty(max(words, 1), dtype=torch.int32, device=cuda)
        code = lib.egs_segmented_cumsum_f32(vals.data_ptr(), flags.data_ptr(), out.data_ptr(),
                                            scratch.data_ptr(), words, rows, m,
                                            torch.cuda.current_stream().cuda_stream)
        assert (code == 0) == code_ok
    torch.cuda.synchronize()


@pytest.mark.parametrize("stack", [False, True])
def test_rasterize_bwd_kernel_matches_plain(cuda, stack):
    t = gaussians_from_numpy(_scene(5, 700, 0, stack=stack), cuda)
    pre = preprocess.fused_preprocess(*(t[k] for k in KEYS), CAM, sh_degree=0)
    b = bin_gaussians(pre["us"], pre["depths"], pre["areas"], pre["valid"], width=CAM.width,
                      height=CAM.height, max_patches=8192, cinv2ds=pre["cinv2ds"],
                      alphas=pre["alphas"])
    args = (pre["table"], b["patch_gsid"], b["tile_start"], b["tile_cnt"])
    _, tau, cont = rasterize.rasterize_fwd(*args, width=CAM.width, height=CAM.height)
    g_img = torch.randn((3, CAM.height, CAM.width), generator=torch.Generator().manual_seed(1))
    kw = dict(width=CAM.width, height=CAM.height)
    got = rasterize.rasterize_bwd(*args, g_img.to(cuda), tau, cont, **kw)
    want = rasterize.rasterize_bwd_plain(*args, g_img.to(cuda), tau, cont, **kw)
    for j in range(9):
        _close_per_group(got[j], want[j], f"row {j}")


@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 255, 256, 257, 511, 512, 513])
def test_rasterize_kernels_on_stacked_tile(cuda, n):
    """K4 and K5 against their plain versions on one tile whose list length
    sits at and around the kernels' batch sizes (K5 64, K4 128), with
    saturated and unsaturated pixels, alpha' on the 0.002 and 0.99
    thresholds and dropped entries: K4 within 1e-4 on image and tau with
    contrib equal on >= 99.99% of pixels, K5 each row within 1e-4 of its
    max|want|, and two K5 calls bit-equal."""
    f = {k: torch.from_numpy(v).to(cuda) for k, v in stacked_tile(n).items()}
    s = f["us"].shape[0]
    table = preprocess.pack_table(f["us"], f["cinv2ds"], f["alphas"], f["colors"],
                                  torch.zeros(s, device=cuda), torch.zeros((s, 2), device=cuda))
    args = (table, f["patch_gsid"], f["tile_start"], f["tile_cnt"])
    kw = dict(width=16, height=16)
    img, tau, cont = rasterize.rasterize_fwd(*args, **kw)
    img_p, tau_p, cont_p = rasterize.rasterize_plain(*args, **kw)
    torch.testing.assert_close(img, img_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(tau, tau_p, atol=1e-4, rtol=0)
    assert float((cont != cont_p).float().mean()) <= 1e-4
    assert int(cont.max()) == n
    g_img = torch.randn((3, 16, 16), generator=torch.Generator().manual_seed(n)).to(cuda)
    got = rasterize.rasterize_bwd(*args, g_img, tau, cont, **kw)
    want = rasterize.rasterize_bwd_plain(*args, g_img, tau, cont, **kw)
    for j in range(9):
        _close_to_scale(got[j], want[j], f"row {j}", 1e-4)
    assert torch.equal(got, rasterize.rasterize_bwd(*args, g_img, tau, cont, **kw))


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_rasterize_kernel_info(cuda, kernel):
    """Each blend kernel fits at least 8 blocks on an SM."""
    info = rasterize.kernel_info(kernel)
    assert 0 < info["registers"] <= 255 and info["blocks_per_sm"] >= 8


def _pool_and_gt(cuda):
    s = make_synthetic_scene(seed=6, n_gaussians=400, n_cams=1, width=64, height=48)
    img, _ = render(s["pws"], s["shs"], s["alphas"], s["scales"], s["rots"], s["cameras"][0],
                    sh_degree=0, max_patches=16384, need_grads=False)
    rng = np.random.default_rng(6)
    pool = pool_from_arrays(s["pws"], s["rots"], s["scales"],
                            np.clip(s["alphas"] + rng.normal(size=400) * 0.1, 0.05, 0.95),
                            s["shs"] + rng.normal(size=s["shs"].shape) * 0.2, capacity=512,
                            device=cuda)
    return pool, s["cameras"][0], img


def test_kernel_step_matches_plain_step(cuda):
    pool, cam, gt = _pool_and_gt(cuda)
    counts = [w.launches for w in (preprocess.preprocess_bwd, rasterize.rasterize_bwd,
                                   scan.segmented_cumsum)]
    loss, grads, aux = loss_and_grads(pool, cam, gt, TrainConfig(max_patches=16384))
    after = [w.launches for w in (preprocess.preprocess_bwd, rasterize.rasterize_bwd,
                                  scan.segmented_cumsum)]
    assert [a - b for a, b in zip(after, counts)] == [1, 1, 1]
    loss_p, grads_p, aux_p = loss_and_grads(pool, cam, gt,
                                            TrainConfig(max_patches=16384, backend="tiled"))
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    # the two forwards round tau differently (sequential products against
    # chunked cumulative ones) and each backward replays from its own
    for k in grads:
        _close_to_scale(grads[k], grads_p[k], k, 1e-2)
    for k in ("total", "n_dropped", "rows_dropped", "gsid_counts"):
        assert torch.equal(aux["binning"][k], aux_p["binning"][k]), k


def test_kernel_gradients_are_bit_equal_across_runs(cuda):
    pool, cam, gt = _pool_and_gt(cuda)
    cfg = TrainConfig(max_patches=16384)
    _, g1, _ = loss_and_grads(pool, cam, gt, cfg)
    _, g2, _ = loss_and_grads(pool, cam, gt, cfg)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


def _sort_inputs(m, seed, n_keys, kind="mixed"):
    """Keys and an int and a float payload. ``mixed``: duplicates and a tail
    keyed INT32_MAX (the reduce's dead patches); ``extremes``: key words at
    and next to INT32_MIN, 0 and INT32_MAX; ``equal``: every key word equal,
    so the order is the input order."""
    g = torch.Generator().manual_seed(seed)
    if kind == "mixed":
        words = [torch.randint(0, max(2, m // 8), (m,), generator=g, dtype=torch.int32),
                 torch.randint(0, 50, (m,), generator=g, dtype=torch.int32)]
        words[0][torch.rand(m, generator=g) < 0.2] = sort.INT32_MAX
    elif kind == "extremes":
        pick = torch.tensor([-2**31, -2**31 + 1, -1, 0, 1, sort.INT32_MAX - 1, sort.INT32_MAX],
                            dtype=torch.int32)
        words = [pick[torch.randint(0, 7, (m,), generator=g)] for _ in range(2)]
    else:
        words = [torch.full((m,), 7, dtype=torch.int32), torch.full((m,), -3, dtype=torch.int32)]
    vals = words[1:n_keys] + [torch.arange(m, dtype=torch.int32), torch.randn(m, generator=g)]
    return words[0], vals


def _kernel_twice(fn, *args, **kwargs):
    """Two calls of a kernel wrapper on the card, each counted once; the
    second must be bit-equal to the first (no state of a call may show)."""
    before = fn.launches
    got = fn(*args, **kwargs)
    again = fn(*args, **kwargs)
    assert fn.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    return got


SORT_LENGTHS = [1, 2, 1000, 4095, 4096, 4097, 65536, 557056]


@pytest.mark.parametrize("kind", ["mixed", "extremes", "equal"])
@pytest.mark.parametrize("m,n_keys", [(m, k) for m in SORT_LENGTHS for k in (1, 2)]
                         + [(2**21, 2)])
def test_sort_kernel_matches_plain(cuda, m, n_keys, kind):
    """The kernel is stable, so it equals the stable plain version exactly,
    payloads (float bits included) and all: at lengths around the 4,096-entry
    tile (4,097: a one-entry right run) and at the routes' sizes (the
    reduce's 557,056 keys, whose 17 runs of 32,768 leave a run with an
    empty partner; two words at the LEX route's 2^21)."""
    keys, vals = _sort_inputs(m, m + n_keys, n_keys, kind)
    got = _kernel_twice(sort.sort_pairs, keys.to(cuda),
                        *(v.to(cuda) for v in vals), n_keys=n_keys)
    want = sort.sort_pairs_plain(keys, *vals, n_keys=n_keys)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n_keys", [1, 2])
@pytest.mark.parametrize("block", [128, 2048, 4096, 8192, 32768])
def test_sort_blocks_kernel_matches_plain(cuda, block, n_keys):
    """Blocks below the tile (sorted inside one CTA), at it, and above it
    (merge passes stopped at the block)."""
    keys, vals = _sort_inputs(65536, block, n_keys)
    got = _kernel_twice(sort.sort_blocks, keys.to(cuda),
                        *(v.to(cuda) for v in vals), block=block, n_keys=n_keys)
    want = sort.sort_blocks_plain(keys, *vals, block=block, n_keys=n_keys)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("one_bucket", [False, True])
@pytest.mark.parametrize("key_bound", [1, 2, 256, 257, 2172, 65537, 5_000_000, 2**31 - 1])
@pytest.mark.parametrize("m", [1, 4095, 4096, 4097, 557056])
def test_counting_sort_kernel_matches_plain(cuda, m, key_bound, one_bucket):
    """One to four 8-bit passes; a heavy top bucket, or every key in one
    bucket (one digit over whole tiles)."""
    g = torch.Generator().manual_seed(m + key_bound)
    key = torch.randint(0, key_bound, (m,), generator=g, dtype=torch.int32)
    key[torch.rand(m, generator=g) < 0.3] = key_bound - 1  # a heavy top bucket
    if one_bucket:
        key[:] = key_bound // 2
    vals = [torch.arange(m, dtype=torch.int32), torch.randn(m, generator=g)]
    got = _kernel_twice(radix.counting_sort, key.to(cuda),
                        *(v.to(cuda) for v in vals), key_bound=key_bound)
    want = radix.counting_sort_plain(key, *vals, key_bound=key_bound)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("key_bound,passes", [
    (1, 1), (2, 1), (256, 1), (257, 2), (2171, 2), (65537, 3), (2**31 - 1, 4)])
def test_counting_sort_pass_plan(cuda, key_bound, passes):
    """csrc/radix.cu's plan: as few 8-bit passes as key_bound allows (2 for
    binning's 2,171 tile ids, 3 for the reduce's 65,537 gaussian ids, 4 at
    2^31 - 1)."""
    assert radix.kernel_plan(1000, key_bound)[0] == passes


@pytest.mark.parametrize("m,key_bound,tiles,hist_blocks", [
    (1, 1, 1, 1), (4096, 2171, 1, 1), (4097, 2171, 2, 2), (557056, 65537, 136, 64)])
def test_counting_sort_scratch_plan(cuda, m, key_bound, tiles, hist_blocks):
    """Scratch: two key and index buffers, the upfront counts of each
    histogram block (at most 64), the digit offsets, the tile counters, one
    look-back word per (pass, 4,096-key tile, digit)."""
    passes, words = radix.kernel_plan(m, key_bound)
    assert words == 3 * m + (hist_blocks + 1) * passes * 256 + 4 + passes * tiles * 256


@pytest.mark.parametrize("m,block,levels", [
    (1, 0, 0), (4095, 0, 0), (4096, 0, 0), (4097, 0, 1), (8192, 0, 1), (8193, 0, 2),
    (65536, 0, 4), (557056, 0, 8), (2**21, 0, 9),
    (16384, 128, 0), (16384, 4096, 0), (16384, 8192, 1), (65536, 32768, 3)])
def test_sort_merge_plan(cuda, m, block, levels):
    """csrc/sort.cu's plan: a CTA sort of 4,096-entry tiles, one merge pass
    per doubling up to the block (0: up to m); scratch of the source indices
    and a ping-pong copy of the key words and indices, at length m."""
    for n_keys in (1, 2):
        assert sort.kernel_plan(m, n_keys, block) == (levels, (n_keys + 2) * m)


ROUTES = {"radix": {"EGS_RADIX_SORT": "1", "EGS_RADIX_REDUCE": "1"},
          "xla_grad_sort_off": {"EGS_XLA_GRAD_SORT": "0"},
          "grad_perm_off": {"EGS_GRAD_PERM": "0"}}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_step_matches_default_step(cuda, route, monkeypatch):
    """Every sort route is stable, so binning, gsid_counts and the gradients
    equal the default route's bit for bit; the route's kernel ran."""
    pool, cam, gt = _pool_and_gt(cuda)
    cfg = TrainConfig(max_patches=16384)
    loss, grads, aux = loss_and_grads(pool, cam, gt, cfg)
    counts = (sort.sort_pairs.launches, radix.counting_sort.launches)
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    loss_r, grads_r, aux_r = loss_and_grads(pool, cam, gt, cfg)
    ran = (sort.sort_pairs.launches - counts[0], radix.counting_sort.launches - counts[1])
    assert ran == {"radix": (0, 2), "xla_grad_sort_off": (2, 0), "grad_perm_off": (1, 0)}[route]
    assert torch.equal(loss, loss_r)
    for k in grads:
        assert torch.equal(grads[k], grads_r[k]), k
    for k in ("patch_gsid", "patch_tile", "tile_start", "tile_cnt", "gsid_counts"):
        assert torch.equal(aux["binning"][k], aux_r["binning"][k]), k


def test_lex_sort_route_matches_default_binning(cuda, monkeypatch):
    """EGS_LEX_SORT=1 where (n_tiles + 1) << mp_bits > 2**32: 65,536 tiles
    at a 2^17 patch budget."""
    g = torch.Generator().manual_seed(7)
    n, w, h = 3000, 16384, 1024
    us = torch.rand((n, 2), generator=g) * torch.tensor([w, h])
    depths = torch.rand(n, generator=g) + 1.0
    areas = torch.rand((n, 2), generator=g) * 40
    valid = torch.rand(n, generator=g) < 0.9
    args = [t.to(cuda) for t in (us, depths, areas, valid)]
    kw = dict(width=w, height=h, max_patches=2**17, max_rows=2**15, gsid_counts=True)
    want = bin_gaussians(*args, **kw)
    monkeypatch.setenv("EGS_LEX_SORT", "1")
    before = sort.sort_pairs.launches
    got = bin_gaussians(*args, **kw)
    assert sort.sort_pairs.launches == before + 1
    for k in ("patch_gsid", "patch_tile", "tile_start", "tile_cnt", "total", "gsid_counts"):
        assert torch.equal(got[k], want[k]), k


def _k9_inputs(q, n_tiles, seed):
    rng = np.random.default_rng(seed)
    packed = torch.from_numpy(rng.normal(size=(16, q * 256)).astype(np.float32))
    tiles = np.sort(rng.integers(0, n_tiles, q)).astype(np.int32)
    if n_tiles > 2:
        tiles[tiles == n_tiles // 2] = n_tiles // 2 + 1  # a tile that no chunk visits
    return packed, torch.from_numpy(np.sort(tiles))


@pytest.mark.parametrize("q,n_tiles", [(0, 3), (1, 1), (40, 9), (6266, 2170), (0, 1), (40, 1),
                                       (3, 9), (120, 3), (129, 17), (130, 9)])
def test_micro_bench_kernels_match_plain(cuda, q, n_tiles):
    """K9a exact zeros; K9b the same float32 adds in chunk order as its plain
    version (bit-equal), tau exact; K9v sums each tile in a fixed tree of
    rounding depth 3 + 3 + (ceil(n / 8) - 1) + 5 over its n chunks (12 at 9
    chunks, 15 at 40: at most 8.9e-7 of the sum of |x| behind a value),
    within 1e-6 of each tile's sum of |x|; two calls of K9b, and of K9v, are
    bit-equal. With no chunk, K9a launches nothing and B and V give zeros;
    (40, 1) is one tile of 40 chunks (K9b's ring of 3 slots then uses a slot
    up to 14 times, so its barrier parity wraps), (3, 9) and (120, 3) hold
    tiles that no chunk visits; (129, 17) and (130, 9) pass the search's
    fan-out of 128 and end one tile past a block of K9v's 8 warp-tiles."""
    packed, tiles = _k9_inputs(q, n_tiles, q)
    pc, tc = packed.to(cuda), tiles.to(cuda)
    before = (micro_bench.variant_a.launches, micro_bench.variant_b.launches,
              micro_bench.variant_vmem_resident.launches)
    a = micro_bench.variant_a(q, pc, tc)
    img, tau = micro_bench.variant_b(q, n_tiles, pc, tc)
    v = micro_bench.variant_vmem_resident(q, n_tiles, pc, tc)
    assert (micro_bench.variant_a.launches, micro_bench.variant_b.launches,
            micro_bench.variant_vmem_resident.launches) == (before[0] + (q > 0), before[1] + 1,
                                                            before[2] + 1)
    assert torch.equal(a.cpu(), torch.zeros(8, 128))
    img_p, tau_p = micro_bench.variant_b_plain(q, n_tiles, packed, tiles)
    assert torch.equal(img.cpu(), img_p) and torch.equal(tau.cpu(), tau_p)
    mag = micro_bench.variant_vmem_resident_plain(q, n_tiles, packed.abs(), tiles)
    v_p = micro_bench.variant_vmem_resident_plain(q, n_tiles, packed, tiles)
    assert bool(((v.cpu() - v_p).abs() <= 1e-6 * mag).all())
    assert not v.cpu()[mag == 0].any()
    assert torch.equal(micro_bench.variant_vmem_resident(q, n_tiles, pc, tc), v)
    img2, tau2 = micro_bench.variant_b(q, n_tiles, pc, tc)
    assert torch.equal(img2, img) and torch.equal(tau2, tau)


@pytest.mark.parametrize("variant", ["a", "b", "vmem_resident"])
def test_micro_bench_kernels_need_16_byte_alignment(cuda, variant):
    """K9a, K9b and K9v read ``packed`` 16 bytes at a time: a view 4 bytes
    into its buffer is refused before any launch."""
    packed, tiles = _k9_inputs(12, 5, 0)
    buf = torch.empty(packed.numel() + 1, device=cuda)
    view = buf[1:].view(packed.shape)
    view.copy_(packed.to(cuda))
    args = (12, view, tiles.to(cuda)) if variant == "a" else (12, 5, view, tiles.to(cuda))
    fn = getattr(micro_bench, f"variant_{variant}")
    before = fn.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(*args)
    assert fn.launches == before


_BAD_TILES_CHILD = """
import numpy as np, torch
from easygaussiansplatting_tpu_torch.probes import micro_bench as mb
rng = np.random.default_rng(0)
q, nt = 300, 9
packed = torch.from_numpy(rng.normal(size=(16, q * 256)).astype(np.float32)).cuda()
for tiles in (rng.integers(0, nt, q), np.sort(rng.integers(-5, nt + 5, q)),
              np.full(q, 2**31 - 1), np.full(q, -2**31), rng.integers(-2**31, 2**31 - 1, q)):
    t = torch.from_numpy(tiles.astype(np.int32)).cuda()
    img, tau = mb.variant_b(q, nt, packed, t)
    v = mb.variant_vmem_resident(q, nt, packed, t)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(img).all() and torch.isfinite(v).all()) and bool((tau == 1).all())
print("in bounds ok")
"""


def test_micro_bench_kernels_stay_in_bounds_on_bad_tiles(cuda):
    """Unsorted, out-of-range and extreme ``tiles`` leave K9b's and K9v's sums
    unspecified (the plain versions raise), but every read stays inside
    ``packed`` and ``tiles``: the calls end without a fault, with finite
    sums and K9b's tau all ones. K9b's bulk copies wait on barriers, so the
    calls run in a child process under a timeout of their own."""
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _BAD_TILES_CHILD], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "in bounds ok" in res.stdout, res.stdout + res.stderr


def test_micro_bench_tile_sums_kernel_info(cuda):
    """K9b as compiled: no spills, and the script's 2,170 tiles (a warp
    each) fit the card's resident blocks in one wave."""
    info = micro_bench.kernel_info("b")
    assert info["local_bytes"] == 0, info
    assert info["threads"] == 32 * info["tiles_per_block"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-micro_bench.N_TILES // info["tiles_per_block"])
    assert blocks <= info["blocks_per_sm"] * n_sm, info


def test_micro_bench_vmem_resident_kernel_info(cuda):
    """K9v as compiled: no spills, and the script's 2,170 tiles (a warp
    each) fit the card's resident blocks in one wave."""
    info = micro_bench.kernel_info("vmem_resident")
    assert info["local_bytes"] == 0, info
    assert info["threads"] == 32 * info["tiles_per_block"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-micro_bench.N_TILES // info["tiles_per_block"])
    assert blocks <= info["blocks_per_sm"] * n_sm, info


@pytest.mark.parametrize("m,q", [(256, 0), (256, 3), (4096, 24), (1 << 18, 4096), (4096, 1),
                                 (4096, 7), (4096, 9)])
def test_stream_sums_kernel_matches_plain(cuda, m, q):
    """float32 column sums of up to 128 rows in another order: within 1e-5
    of the sums of |x|, and two calls are bit-equal. With no chunk, nothing
    is launched. q of 1, 7 and 9 leave a block fewer chunks than the ring
    has stages; rows of 1 and 128 sit at both ends of x."""
    x, offs, rows = exp_dma_stream.make_inputs(m=m, q_total=q)
    ends = ((0, 128), (m - 128, 1), (0, 1), (m - 128, 128))[:q]
    offs[:len(ends)], rows[:len(ends)] = zip(*ends) if ends else ((), ())
    x, offs, rows = (torch.from_numpy(a) for a in (x, offs, rows))
    before = exp_dma_stream.stream_sums.launches
    got = exp_dma_stream.stream_sums(offs.to(cuda), rows.to(cuda), x.to(cuda))
    assert exp_dma_stream.stream_sums.launches == before + (q > 0)
    want = exp_dma_stream.stream_sums_plain(offs, rows, x)
    mag = exp_dma_stream.stream_sums_plain(offs, rows, x.abs())
    assert got.shape == (q, 1, 16)
    assert bool(((got.cpu() - want).abs() <= 1e-5 * mag).all())
    again = exp_dma_stream.stream_sums(offs.to(cuda), rows.to(cuda), x.to(cuda))
    assert torch.equal(again, got)


_CLAMP_CHILD = """
import numpy as np, torch
from easygaussiansplatting_tpu_torch.probes import exp_dma_stream as e
m = 1024
x, offs, rows = e.make_inputs(m=m, q_total=19)
offs[:10] = (-5, m - 127, m + 1000, 2**31 - 1, -2**31, 0, m - 128, 7, 7, 300)
rows[:10] = (0, 129, -3, 128, 64, 2**31 - 1, -2**31, 0, 0, 0)
got = e.stream_sums(*(torch.from_numpy(a).cuda() for a in (offs, rows, x)))
torch.cuda.synchronize()
o, r = np.clip(offs.astype(np.int64), 0, m - 128), np.clip(rows, 0, 128)
want = np.stack([x[a:a + n].sum(0) for a, n in zip(o, r)])
mag = np.stack([np.abs(x[a:a + n]).sum(0) for a, n in zip(o, r)])
err = np.abs(got.cpu().numpy()[:, 0] - want)
assert (err <= 1e-5 * mag).all(), err.max()
assert not got[[0, 2, 6, 7, 8, 9]].any()
print("clamped ok")
"""


def test_stream_sums_kernel_clamps_out_of_range_values(cuda):
    """Offsets and row counts out of range, a row count of 0 among them, are
    clamped (offs into [0, m - 128], rows into [0, 128]) and the sums match
    a numpy reference of the clamp; the plain version raises on these
    inputs. A row count of 0 issues no copy, so a wrong barrier count would
    hang: the call runs in a child process under a timeout of its own."""
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _CLAMP_CHILD], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and "clamped ok" in res.stdout, res.stdout + res.stderr


def test_stream_sums_kernel_needs_16_byte_alignment(cuda):
    """A bulk copy's source is 16-byte aligned: a view of x 4 bytes into its
    buffer is refused before any launch."""
    x, offs, rows = (torch.from_numpy(a).to(cuda) for a in exp_dma_stream.make_inputs(1024, 8))
    buf = torch.empty(x.numel() + 1, device=cuda)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        exp_dma_stream.stream_sums(offs, rows, view)


def test_stream_sums_kernel_info(cuda):
    """K10 as compiled: no spills, a ring of at least 4 stages, and the
    script's 4,096 chunks fit the card's resident blocks in one wave."""
    info = exp_dma_stream.kernel_info()
    assert info["local_bytes"] == 0 and info["stages"] >= 4, info
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-exp_dma_stream.Q_TOTAL // info["chunks_per_block"])
    assert blocks <= info["blocks_per_sm"] * n_sm, info


def _fixture_ref():
    return np.load(FIXTURES / "reference.npz")


def _levels(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    return int(d.max()), float(d.mean())


def _within_nvjpeg_limits(got, want):
    worst, mean = _levels(got, want)
    return worst <= image_io.NVJPEG_MAX_ABS and mean <= image_io.NVJPEG_MEAN_ABS


@pytest.mark.parametrize("name", sorted(JPEGS))
def test_nvjpeg_matches_pil_within_its_limits(cuda, name):
    """nvJPEG's decode of each committed JPEG against PIL's (reference.npz)
    within NVJPEG_MAX_ABS and NVJPEG_MEAN_ABS levels, and the same limits
    refuse each planted fault; grey comes out replicated to RGB."""
    want = _fixture_ref()[f"decode/{name}"]
    got = image_io.decode_jpeg_cuda((FIXTURES / name).read_bytes(), cuda)
    assert got.dtype == torch.uint8 and got.device.type == "cuda" and got.shape == want.shape
    got = got.cpu().numpy()
    assert _within_nvjpeg_limits(got, want), _levels(got, want)
    for fault, bad in planted_faults(got).items():
        assert not _within_nvjpeg_limits(bad, want), (fault, _levels(bad, want))
    if name == "jpeg_gray.jpg":
        assert (got[..., 0] == got[..., 1]).all() and (got[..., 1] == got[..., 2]).all()


@pytest.mark.parametrize("name", sorted(JPEGS) + sorted(PNGS))
def test_cuda_resize_and_png_decode_bit_equal_to_pil(cuda, name):
    """The resize on CUDA tensors bit-equal to PIL's committed resizes (of
    PIL's own decode), and load_rgb8 of each PNG on the card bit-equal to
    PIL's decode and resizes and to the CPU path."""
    ref = _fixture_ref()
    for rate in RATES:
        want = ref[f"resize{rate}/{name}"]
        if name in JPEGS:
            dec = torch.from_numpy(ref[f"decode/{name}"]).to(cuda)
            got = image_io.pillow_resize(dec, "RGB", (want.shape[1], want.shape[0]))
        else:
            got = image_io.load_rgb8(FIXTURES / name, rate, cuda)
            assert torch.equal(got.cpu(), image_io.load_rgb8(FIXTURES / name, rate, "cpu"))
        assert got.device.type == "cuda" and np.array_equal(got.cpu().numpy(), want), rate
    if name in PNGS:
        got = load_image(FIXTURES / name, 1.0, device=cuda)
        assert torch.equal(got.cpu(), load_image(FIXTURES / name, 1.0, device="cpu"))


def test_load_image_on_cuda_takes_nvjpeg_for_jpeg(cuda):
    calls = image_io.decode_jpeg_cuda.calls
    img = load_image(FIXTURES / "jpeg_420.jpg", 0.5, device=cuda)
    assert image_io.decode_jpeg_cuda.calls == calls + 1
    assert img.shape == (3, 36, 48) and img.dtype == torch.float32 and img.device.type == "cuda"


def test_degenerate_scene_through_the_kernels(cuda):
    """tests/test_torch_robustness.py's scene through K1, K2, K4 and K5:
    image, final_tau and every gradient finite, the image within the render
    path's 1e-4 of the plain path and the gradients within the step's
    1e-2 * max|plain| of the plain path's."""
    wrappers = (preprocess.preprocess_fwd, preprocess.preprocess_bwd,
                rasterize.rasterize_fwd, rasterize.rasterize_bwd)
    runs = {}
    for backend in ("cuda", "tiled"):
        args = [torch.tensor(a, device=cuda, requires_grad=True) for a in degenerate_scene()]
        before = [w.launches for w in wrappers]
        img, aux = render(*args, CAM, backend=backend, max_patches=4096, sh_degree=0)
        (img ** 2).sum().backward()
        if backend == "cuda":
            assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 1, 1, 1]
        assert bool(torch.isfinite(img).all()) and bool(torch.isfinite(aux["final_tau"]).all())
        for t, k in zip(args, KEYS):
            assert bool(torch.isfinite(t.grad).all()), (backend, k)
        runs[backend] = (img.detach(), [t.grad for t in args])
    torch.testing.assert_close(runs["cuda"][0], runs["tiled"][0], atol=1e-4, rtol=0)
    for got, want, k in zip(runs["cuda"][1], runs["tiled"][1], KEYS):
        _close_to_scale(got, want, k, 1e-2)


def test_all_culled_scene_through_the_kernels(cuda):
    pws, shs, alphas, scales, rots = (torch.tensor(a, device=cuda) for a in culled_scene())
    pws.requires_grad_(True)
    img, _ = render(pws, shs, alphas, scales, rots, CAM, max_patches=4096, sh_degree=0)
    img.sum().backward()
    assert float(img.detach().abs().max()) == 0.0
    assert float(pws.grad.abs().max()) == 0.0 and bool(torch.isfinite(pws.grad).all())


# ---------------------------------------------------------------- the viewer and bench_scene

def _viewer_fixture(device, backend):
    from easygaussiansplatting_tpu_torch.data import example_gaussians
    from easygaussiansplatting_tpu_torch.data.synthetic import look_at_camera
    from easygaussiansplatting_tpu_torch.viewer.server import SceneRenderer

    g = example_gaussians()
    gs = {k: g[k] for k in KEYS}
    cams = [look_at_camera(p, np.zeros(3), 64, 48, 60.0, cam_id=i)
            for i, p in enumerate(np.array([[0.8, 0.2, 0.3], [0.2, 0.8, 0.3]]))]
    cloud = {"pws": gs["pws"], "rots": gs["rots"],
             "scales": np.full_like(np.asarray(gs["scales"], np.float32), 0.01),
             "alphas": np.full(len(gs["pws"]), 0.9, np.float32),
             "shs": np.asarray(gs["shs"], np.float32)[:, :3]}
    return SceneRenderer(gs, dataset_cameras=cams, cloud=cloud, marker_skip=1, backend=backend,
                         max_patches=2**12, device=device)


@pytest.mark.parametrize("kw", [dict(mode="normal"), dict(mode="ball", markers=True),
                                dict(mode="inverse", cloud=True, cloud_mode="rainbow"),
                                dict(axes=True, grid=True), dict(lores=True)])
def test_viewer_frame_kernels_match_plain(cuda, kw):
    """A SceneRenderer frame on the card's kernels against the all-plain
    path on the card: within 1 level, at most 0.1% of the pixels a level
    off; K1 once, K3's 3 calls and K4 once a frame."""
    kern, plain = _viewer_fixture(cuda, "cuda"), _viewer_fixture(cuda, "tiled")
    view = dict(azimuth=0.7, elevation=0.3, width=256, height=192)
    wrappers = (preprocess.preprocess_fwd, scan.multi_cumsum, rasterize.rasterize_fwd)
    before = [w.launches for w in wrappers]
    got = kern.render(**view, **kw)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 3, 1]
    want = plain.render(**view, **kw)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.shape == want.shape and d.max() <= 1 and (d > 0).any(-1).mean() <= 1e-3


def test_turntable_on_the_card_matches_the_cpu(cuda):
    from easygaussiansplatting_tpu_torch.data import example_gaussians
    from easygaussiansplatting_tpu_torch.viewer.headless import render_turntable

    g = example_gaussians()
    gs = {k: g[k] for k in KEYS}
    kw = dict(max_patches=2**10, n_frames=3, width=32, height=32)
    got = render_turntable(gs, device=cuda, **kw)
    want = render_turntable(gs, device="cpu", **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_sh_demo_on_the_card_matches_the_cpu(cuda):
    from easygaussiansplatting_tpu_torch import sh_demo

    img = sh_demo.procedural_texture(32, 64)
    (got, _), (want, _) = sh_demo.fit_sh(img, 5, cuda), sh_demo.fit_sh(img, 5, "cpu")
    np.testing.assert_allclose(got, want, atol=1e-4)
    a = sh_demo.make_sphere_renderer(img, want, res=48, device=cuda)(1.0).cpu().numpy()
    b = sh_demo.make_sphere_renderer(img, want, res=48, device="cpu")(1.0).numpy()
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_bench_scene_smoke_launches_per_step_and_render(cuda, capsys):
    """One --smoke epoch on the card: K2, K5, K6 once a step; K1, K4 once a
    step and once a render (8 ground-truth views, 4 eval views, the
    training loop's eval at its last epoch); K3 three times each of those."""
    from easygaussiansplatting_tpu_torch import bench_scene

    wrappers = (preprocess.preprocess_fwd, preprocess.preprocess_bwd, scan.multi_cumsum,
                rasterize.rasterize_fwd, rasterize.rasterize_bwd, scan.segmented_cumsum)
    before = [w.launches for w in wrappers]
    lines, state = bench_scene.main(["--smoke", "--epochs", "1"])
    steps, renders = 8, 8 + 4 + 1
    assert [w.launches - b for w, b in zip(wrappers, before)] == [
        steps + renders, steps, 3 * (steps + renders), steps + renders, steps, steps]
    assert "backend=cuda" in capsys.readouterr().out
    assert lines[1]["metric"] == "time_to_psnr25" and state["history"]["overflow_steps"] == [0]


# ---- the multi-device layer (parallel/) on the card

def _md_scene(device):
    """A small scene, a pool with perturbed opacities and colours and the
    ground truth of its 2 views, for the multi-device cases."""
    s = make_synthetic_scene(seed=4, n_gaussians=600, n_cams=2, width=96, height=80,
                             log_scale_mean=-2.6)
    pool = pool_from_arrays(s["pws"], s["rots"], s["scales"], s["alphas"] * 0.8,
                            s["shs"] * 0.5, capacity=640, device=device)
    args = [s[k] for k in ("pws", "shs", "alphas", "scales", "rots")]
    gts = [render(*args, cam, sh_degree=0, max_patches=2**14, need_grads=False,
                  device=device)[0] for cam in s["cameras"]]
    return s, pool, gts, TrainConfig(max_patches=2**14)


def test_sharded_step_at_world_size_one_under_nccl(cuda):
    """World size 1 under NCCL in this process: the batched step at batch 1
    is bit-equal to make_train_step (the gather of one shard and the reduce
    over one rank are identities)."""
    import copy

    import torch.distributed as dist

    from easygaussiansplatting_tpu_torch.parallel.distributed import free_port
    from easygaussiansplatting_tpu_torch.parallel.mesh import make_mesh
    from easygaussiansplatting_tpu_torch.parallel.train import (
        make_sharded_train_step,
        shard_pool,
    )
    from easygaussiansplatting_tpu_torch.train.density import density_stats_init
    from easygaussiansplatting_tpu_torch.train.loop import make_train_step
    from easygaussiansplatting_tpu_torch.train.optimizer import adam_init

    s, pool, gts, cfg = _md_scene(cuda)
    states = []
    for _ in range(2):
        p = copy.deepcopy(pool)
        states.append([p, adam_init(p.params()), density_stats_init(p.capacity, cuda)])
    (p1, a1, s1), (p2, a2, s2) = states
    loss1, _ = make_train_step(cfg, s["scene_size"], 10, device=cuda)(p1, a1, s1,
                                                                     s["cameras"][0], gts[0])
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh(1)
        p2, a2, s2 = shard_pool(mesh, p2, a2, s2)
        loss2, binfo = make_sharded_train_step(mesh, cfg, s["scene_size"], 10)(
            p2, a2, s2, s["cameras"][:1], gts[:1])
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert torch.equal(loss1, loss2) and int(binfo["dropped"]) == 0
    for k, v in p1.params().items():
        assert torch.equal(v, getattr(p2, k)), k
        assert torch.equal(a1.mu[k], a2.mu[k]) and torch.equal(a1.nu[k], a2.nu[k]), k
    assert torch.equal(s1.grad_accum, s2.grad_accum) and torch.equal(s1.cunt, s2.cunt)


def _gloo_rank(rank, port, out):
    """One of two ranks on cuda:0 joined by gloo: the banded render over 2
    bands and the batched step's loss and gradients on (data 1, gs 2)."""
    from easygaussiansplatting_tpu_torch.parallel.distributed import (
        fetch_to_host,
        init_distributed,
    )
    from easygaussiansplatting_tpu_torch.parallel.mesh import make_mesh
    from easygaussiansplatting_tpu_torch.parallel.train import (
        make_sharded_render,
        shard_pool,
        sharded_loss_and_grads,
    )

    dev = init_distributed(f"localhost:{port}", 2, rank, device="cuda:0", backend="gloo",
                           timeout_s=120)
    s, pool, gts, cfg = _md_scene(dev)
    mesh = make_mesh(2)
    assert mesh.shape == {"data": 1, "gs": 2}
    shard = shard_pool(mesh, pool)
    img, aux = make_sharded_render(mesh, cfg, with_aux=True)(shard, s["cameras"][0])
    loss, grads, _, dropped = sharded_loss_and_grads(mesh, shard, s["cameras"], gts, cfg)
    grads = fetch_to_host(mesh, grads, device="cpu")
    if rank == 0:
        torch.save({"image": img.cpu(), "n_dropped": int(aux["n_dropped"]),
                    "loss": float(loss), "grads": grads, "dropped": int(dropped)}, out)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def two_gloo_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled with nvcc on the card")
    import os

    from easygaussiansplatting_tpu_torch.ops.kernels import _build
    from easygaussiansplatting_tpu_torch.parallel.distributed import free_port, launch_ranks

    _build.library()  # built here, so that the ranks only load it
    root = Path(__file__).resolve().parents[1]
    out = tmp_path_factory.mktemp("gloo") / "ranks.pt"
    port = free_port()
    launch_ranks(lambda r: [sys.executable, __file__, "--gloo-rank", str(r), str(port), str(out)],
                 2, 300, env={**os.environ, "PYTHONPATH": str(root)}, cwd=root)
    return torch.load(out)


def test_banded_render_on_two_gloo_ranks_matches_render(cuda, two_gloo_ranks):
    """2 bands, one a rank, on one card: within the render gate of
    chip_smoke.py (at most 0.1% of the pixels over 1e-4), 0 drops."""
    s, pool, _, cfg = _md_scene(cuda)
    from easygaussiansplatting_tpu_torch.train.loop import render_pool_image

    want, _ = render_pool_image(pool, s["cameras"][0], cfg, need_grads=False)
    got = two_gloo_ranks["image"].to(cuda)
    assert got.shape == want.shape and two_gloo_ranks["n_dropped"] == 0
    assert float(((got - want).abs() > 1e-4).any(dim=0).float().mean()) <= 1e-3


def test_batched_step_on_two_gloo_ranks_matches_world_size_one(cuda, two_gloo_ranks):
    """The batch of 2 views on (data 1, gs 2) against world size 1 (one
    rank, no process group): the loss within rel 1e-5, each gradient group
    within 1e-4 of its max|g|, 0 drops."""
    from easygaussiansplatting_tpu_torch.parallel.mesh import make_mesh
    from easygaussiansplatting_tpu_torch.parallel.train import sharded_loss_and_grads

    s, pool, gts, cfg = _md_scene(cuda)
    loss, grads, _, dropped = sharded_loss_and_grads(make_mesh(), pool, s["cameras"], gts, cfg)
    assert two_gloo_ranks["dropped"] == 0 == int(dropped)
    np.testing.assert_allclose(two_gloo_ranks["loss"], float(loss), rtol=1e-5)
    for k, want in grads.items():
        got = two_gloo_ranks["grads"][k].to(cuda)
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), k


if __name__ == "__main__" and sys.argv[1:2] == ["--gloo-rank"]:
    _gloo_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
