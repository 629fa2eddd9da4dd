"""PyTorch port on the card: K12 (csrc/binning.cu, ops/kernels/binning.py)
against the slot path of ops/binning.py on the same CUDA inputs. Every
output is equal: the draw lists, the tile ranges, the counts and
gsid_counts, under every budget (ample, a patch overflow, a row overflow,
a row budget that splits one gaussian's rows), with conics and without,
for no valid gaussian, one gaussian, 160x120 and 640x480 views of a
200,000-gaussian scene and views of up to 129,600 tiles (counted in bands
of tiles); and the viewer's frame is the same on both routes. K12 raises on
float64 inputs instead of taking another route.
Every test here needs a CUDA device and nvcc, and skips without one.

The file imports no JAX:

    python -m pytest tests/test_torch_binning_kernel.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu_torch.data.synthetic import make_synthetic_scene
from easygaussiansplatting_tpu_torch.models.convert import gaussians_from_numpy
from easygaussiansplatting_tpu_torch.ops import binning
from easygaussiansplatting_tpu_torch.ops.kernels import binning as kernel_binning
from easygaussiansplatting_tpu_torch.ops.kernels import preprocess, scan
from easygaussiansplatting_tpu_torch.viewer.server import SceneRenderer

pytestmark = pytest.mark.cuda

KEYS = ("pws", "shs", "alphas", "scales", "rots")
INT_KEYS = ("patch_gsid", "patch_tile", "tile_start", "tile_cnt", "total",
            "n_dropped", "rows_dropped", "total_rows")
W, H = 64, 48
BIG = 200_000


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled with nvcc on the card")
    return torch.device("cuda")


def _views(device, seed, n=300, width=W, height=H, log_scale_mean=-2.6):
    """K1's table views of a synthetic scene from its first camera."""
    s = make_synthetic_scene(seed=seed, n_gaussians=n, n_cams=1, width=width, height=height,
                             log_scale_mean=log_scale_mean)
    t = gaussians_from_numpy(s, device)
    return preprocess.fused_preprocess(*(t[k] for k in KEYS), s["cameras"][0], sh_degree=0)


def _bin(pre, conics, width=W, height=H, **kw):
    extra = dict(cinv2ds=pre["cinv2ds"], alphas=pre["alphas"]) if conics else {}
    return binning.bin_gaussians(pre["us"], pre["depths"], pre["areas"], pre["valid"],
                                 width=width, height=height, **extra, **kw)


def _both(pre, conics, monkeypatch, **kw):
    """(K12's outputs, the slot path's) on the same inputs; K12 ran once."""
    before = kernel_binning.bin_lists.launches
    got = _bin(pre, conics, **kw)
    assert kernel_binning.bin_lists.launches == before + 1 and got["kernel"] is True
    with monkeypatch.context() as m:
        m.setattr(binning, "takes_kernel", lambda *args: False)
        want = _bin(pre, conics, **kw)
    assert want["kernel"] is False
    return got, want


def _assert_equal(got, want, gsid_counts):
    torch.cuda.synchronize()
    for k in INT_KEYS + (("gsid_counts",) if gsid_counts else ()):
        assert got[k].dtype == want[k].dtype == torch.int32, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    assert ("gsid_counts" in got) == gsid_counts


def _split_rows(pre, conics):
    """A row budget that ends inside one gaussian's rows: one tile-row into
    the middle gaussian of those with two or more."""
    valid = pre["valid"] & (pre["alphas"] >= binning.ALPHA_SKIP) if conics else pre["valid"]
    keys = torch.where(valid, pre["depths"], torch.inf).contiguous().view(torch.int32)
    order = torch.sort(keys, stable=True).indices
    rects, valid = binning.gaussian_rects(pre["us"], pre["areas"], valid, W, H)
    rows = torch.where(valid, rects[:, 3] - rects[:, 1], 0)[order]
    start = torch.cumsum(rows, 0) - rows
    tall = torch.nonzero(rows >= 2).flatten()
    return int(start[tall[len(tall) // 2]]) + 1


BUDGETS = ("ample", "patch_overflow", "row_overflow", "row_split")


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("gsid_counts", [False, True])
@pytest.mark.parametrize("conics", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_matches_slot_path(cuda, monkeypatch, seed, conics, gsid_counts, budget):
    pre = _views(cuda, seed)
    kw = {"ample": lambda: dict(max_patches=4096),
          "patch_overflow": lambda: dict(max_patches=256, max_rows=4096),
          "row_overflow": lambda: dict(max_patches=4096, max_rows=128),
          "row_split": lambda: dict(max_patches=4096, max_rows=_split_rows(pre, conics))}[budget]()
    got, want = _both(pre, conics, monkeypatch, gsid_counts=gsid_counts, **kw)
    _assert_equal(got, want, gsid_counts)
    total, dropped = int(want["total"]), int(want["n_dropped"])
    assert total > 100
    assert (dropped > 0) == (budget == "patch_overflow")
    assert (int(want["rows_dropped"]) > 0) == (budget in ("row_overflow", "row_split"))


@pytest.mark.parametrize("gsid_counts", [False, True])
@pytest.mark.parametrize("conics", [True, False])
@pytest.mark.parametrize("case", ["none_valid", "one"])
def test_kernel_matches_slot_path_at_the_edges(cuda, monkeypatch, case, conics, gsid_counts):
    pre = _views(cuda, 3)
    if case == "none_valid":
        pre = dict(pre, valid=torch.zeros_like(pre["valid"]))
    else:  # the frontmost gaussian that covers a tile, alone
        _, covers = binning.gaussian_rects(pre["us"], pre["areas"], pre["valid"], W, H)
        i = int(torch.argmin(torch.where(covers, pre["depths"], torch.inf)))
        pre = {k: v[i:i + 1] for k, v in pre.items()}
    got, want = _both(pre, conics, monkeypatch, gsid_counts=gsid_counts, max_patches=4096)
    _assert_equal(got, want, gsid_counts)
    assert (int(want["total"]) > 0) == (case == "one")
    if case == "none_valid":
        assert bool((got["patch_gsid"] == -1).all()) and int(got["tile_cnt"].sum()) == 0


@pytest.mark.parametrize("size", [(160, 120), (640, 480)])
def test_kernel_matches_slot_path_on_a_large_scene(cuda, monkeypatch, size):
    w, h = size
    pre = _views(cuda, 5, n=BIG, width=w, height=h, log_scale_mean=-3.6)
    got, want = _both(pre, True, monkeypatch, width=w, height=h, gsid_counts=True,
                      max_patches=2**21)
    _assert_equal(got, want, True)
    assert int(want["total"]) > BIG // 2 and int(want["n_dropped"]) == 0


@pytest.mark.parametrize("size,bands", [((2048, 1536), 1), ((4096, 3072), 4),
                                        ((4096, 4096), 5), ((7680, 4320), 9)])
def test_kernel_matches_slot_path_on_many_tiles(cuda, monkeypatch, size, bands):
    """12,288 tiles: a block's tile counters take more than the default 48 KB
    of shared memory; 49,152, 65,536 (the viewer's 4096x4096) and 129,600
    (7680x4320) tiles: more than one band."""
    w, h = size
    pre = _views(cuda, 7, n=2000, width=w, height=h, log_scale_mean=-1.9)
    plan = kernel_binning.kernel_plan(binning.num_tiles(w, h)[0] * binning.num_tiles(w, h)[1],
                                      2**21)
    assert plan["smem"] > 48 * 1024 and plan["bands"] == bands
    got, want = _both(pre, True, monkeypatch, width=w, height=h, gsid_counts=True,
                      max_patches=2**21)
    _assert_equal(got, want, True)
    assert int(want["total"]) > 10_000


@pytest.mark.parametrize("conics", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_prep_matches_the_slot_paths_preparation(cuda, seed, conics):
    """K12's first kernel: the depth keys, ``gaussian_rects`` and
    ``skip_radius2`` of the slot path, bit for bit."""
    pre = _views(cuda, seed, n=20_000, width=320, height=240, log_scale_mean=-2.6)
    kw = dict(cinv2ds=pre["cinv2ds"], alphas=pre["alphas"]) if conics else {}
    keys, rects, valid, r2 = kernel_binning.prep(pre["us"], pre["depths"], pre["areas"],
                                                 pre["valid"], gx=20, gy=15, **kw)
    want_valid = pre["valid"] & (pre["alphas"] >= binning.ALPHA_SKIP) if conics else pre["valid"]
    want_keys = torch.where(want_valid, pre["depths"], torch.inf).contiguous().view(torch.int32)
    want_rects, want_valid = binning.gaussian_rects(pre["us"], pre["areas"], want_valid, 320, 240)
    assert torch.equal(keys, want_keys) and torch.equal(rects, want_rects)
    assert torch.equal(valid, want_valid) and bool(valid.any())
    want_r2 = (binning.skip_radius2(pre["alphas"]) if conics
               else torch.full_like(r2, torch.inf))
    assert torch.equal(r2.view(torch.int32), want_r2.view(torch.int32))


def test_prep_skip_radius_is_bit_equal_for_every_alpha(cuda):
    """The skip radius^2 of every float32 alpha in [2^-40, 2), 344 M values:
    K12's logf against PyTorch's log, bit for bit."""
    chunk = 2**24
    lo = int(np.float32(2.0**-40).view(np.int32))
    hi = int(np.float32(2.0).view(np.int32))
    zeros2 = torch.zeros((chunk, 2), device=cuda)
    depths = torch.ones(chunk, device=cuda)
    valid = torch.ones(chunk, dtype=torch.bool, device=cuda)
    conic = torch.zeros((chunk, 3), device=cuda)
    for start in range(lo, hi, chunk):
        bits = torch.arange(start, start + chunk, dtype=torch.int32, device=cuda)
        alphas = torch.minimum(bits, torch.tensor(hi - 1, device=cuda)).view(torch.float32)
        _, _, _, r2 = kernel_binning.prep(zeros2, depths, zeros2, valid, cinv2ds=conic,
                                          alphas=alphas, gx=4, gy=3)
        want = binning.skip_radius2(alphas)
        assert torch.equal(r2.view(torch.int32), want.view(torch.int32)), start


def test_kernel_makes_no_host_sync(cuda):
    """K12's route reads nothing back: it binds under a sync-debug mode that
    raises on any synchronising call."""
    pre = _views(cuda, 0)
    _bin(pre, True, max_patches=4096, gsid_counts=True)  # build and warm
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _bin(pre, True, max_patches=4096, gsid_counts=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out["kernel"] is True


def test_kernel_plan(cuda):
    """The plan: chunks of at least 2,048 slots covering the budget, a
    [n_tiles, chunks] count matrix of at most 2^22 cells where the chunk can
    grow, bands of tiles covering the view whose counters fit a block's
    shared memory, at any tile count; no plan only for a budget past int32
    positions or below one slot, or no tile."""
    for n_tiles, mp in ((80, 4_718_592), (1200, 4_718_592), (2170, 557_056), (1, 1),
                        (58_113, 2**20), (129_600, 4_718_592), (80, 2**31 - 1), (4_000_000, 2**24)):
        p = kernel_binning.kernel_plan(n_tiles, mp)
        assert p["chunk"] >= 2048 and p["chunks"] * p["chunk"] >= mp
        assert (p["chunks"] - 1) * p["chunk"] < mp
        assert p["cells"] == n_tiles * p["chunks"] <= max(2**22, n_tiles)
        assert p["band"] * p["bands"] >= n_tiles > p["band"] * (p["bands"] - 1)
        assert p["warps"] == 4 and p["smem"] == 4 * p["band"] * p["warps"] <= 232_448
    for n_tiles, mp in ((80, 2**31), (80, 0), (0, 4096)):
        assert kernel_binning.kernel_plan(n_tiles, mp) is None


def test_kernel_raises_on_float64_and_past_int32_budgets(cuda):
    """A wrong dtype or budget is an error on the kernel route, never a
    quiet turn to the slot path."""
    pre = _views(cuda, 0)
    with pytest.raises(ValueError, match="float32"):
        _bin({k: v.double() if torch.is_floating_point(v) else v for k, v in pre.items()}, True,
             max_patches=4096)
    with pytest.raises(ValueError, match="2\\^31"):
        _bin(pre, True, max_patches=2**31)


@pytest.mark.parametrize("lores", [True, False])
def test_viewer_frame_is_the_same_on_both_routes(cuda, monkeypatch, lores):
    """SceneRenderer.render_device on the 200,000-gaussian scene: the same
    frame_u8 from K12's lists as from the slot path's, with K12 and K3's
    two calls launched once a frame."""
    s = make_synthetic_scene(seed=6, n_gaussians=BIG, n_cams=1, log_scale_mean=-3.6)
    renderer = SceneRenderer({k: s[k] for k in KEYS}, max_patches=2**21, device=cuda)
    view = dict(azimuth=0.4, elevation=0.3, width=640, height=480, lores=lores)
    before = (kernel_binning.bin_lists.launches, scan.multi_cumsum.launches)
    got = renderer.render_device(**view)
    assert (kernel_binning.bin_lists.launches - before[0],
            scan.multi_cumsum.launches - before[1]) == (1, 2)
    with monkeypatch.context() as m:
        m.setattr(binning, "takes_kernel", lambda *args: False)
        want = renderer.render_device(**view)
    assert got.shape == want.shape == ((120, 160, 3) if lores else (480, 640, 3))
    assert torch.equal(got, want) and float(got.float().std()) > 1.0
