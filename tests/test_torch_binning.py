"""PyTorch port: tile binning against the JAX binning on the same (JAX-stage)
arrays — every integer output exactly equal."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.data.synthetic import make_synthetic_scene
from easygaussiansplatting_tpu.ops import binning as jax_binning
from easygaussiansplatting_tpu.ops import stages as jax_stages
from easygaussiansplatting_tpu_torch.ops import binning
from easygaussiansplatting_tpu_torch.ops.rasterize import raster_from_aux
from easygaussiansplatting_tpu_torch.utils import trace

torch.set_num_threads(2)

INT_KEYS = ("patch_gsid", "patch_tile", "tile_start", "tile_cnt", "total",
            "n_dropped", "rows_dropped", "total_rows")
W, H = 64, 48


def _stage_arrays(seed, n=300):
    """JAX stage outputs of a small synthetic scene (depths are continuous
    random values: no ties)."""
    scene = make_synthetic_scene(seed=seed, n_gaussians=n, n_cams=1, width=W, height=H,
                                 log_scale_mean=-2.6)
    args = [jnp.asarray(scene[k], jnp.float32)
            for k in ("pws", "shs", "alphas", "scales", "rots")]
    aux = jax_stages.preprocess(*args, scene["cameras"][0], sh_degree=0)
    return {k: np.array(aux[k]) for k in
            ("us", "depths", "areas", "valid", "cinv2ds", "alphas")}


def _bin_both(a, conics, gsid_counts=False, **budget):
    jkw = dict(width=W, height=H, gsid_counts=gsid_counts, **budget)
    if conics:
        jkw.update(cinv2ds=jnp.asarray(a["cinv2ds"]), alphas=jnp.asarray(a["alphas"]))
    want = jax_binning.bin_gaussians(
        jnp.asarray(a["us"]), jnp.asarray(a["depths"]), jnp.asarray(a["areas"]),
        jnp.asarray(a["valid"]), **jkw)
    tkw = dict(width=W, height=H, gsid_counts=gsid_counts, **budget)
    if conics:
        tkw.update(cinv2ds=torch.from_numpy(a["cinv2ds"]), alphas=torch.from_numpy(a["alphas"]))
    got = binning.bin_gaussians(
        torch.from_numpy(a["us"]), torch.from_numpy(a["depths"]),
        torch.from_numpy(a["areas"]), torch.from_numpy(a["valid"]), **tkw)
    return got, want


def _assert_equal(got, want):
    for k in INT_KEYS:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("conics", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_binning_matches_jax(seed, conics):
    a = _stage_arrays(seed)
    got, want = _bin_both(a, conics, max_patches=4096)
    assert int(want["n_dropped"]) == 0 and int(want["total"]) > 100
    _assert_equal(got, want)


@pytest.mark.parametrize("conics", [True, False])
def test_patch_budget_overflow_matches_jax(conics):
    a = _stage_arrays(2)
    got, want = _bin_both(a, conics, max_patches=256, max_rows=4096)
    assert int(want["n_dropped"]) > 0
    _assert_equal(got, want)


@pytest.mark.parametrize("conics", [True, False])
def test_row_budget_overflow_matches_jax(conics):
    a = _stage_arrays(3)
    got, want = _bin_both(a, conics, max_patches=4096, max_rows=128)
    assert int(want["rows_dropped"]) > 0
    _assert_equal(got, want)


def test_tile_ranges_cover_sorted_ids():
    """The counted per-tile ranges agree with the sorted tile ids."""
    a = _stage_arrays(4)
    got, _ = _bin_both(a, True, max_patches=300)
    tile = got["patch_tile"].numpy()
    for t, (s, c) in enumerate(zip(got["tile_start"].numpy(), got["tile_cnt"].numpy())):
        assert np.all(tile[s:s + c] == t)
    assert int(got["tile_cnt"].sum()) == min(int(got["total"]), 300)


def test_gaussian_rects_and_num_tiles(rng):
    us = rng.uniform(-20, 90, size=(64, 2)).astype(np.float32)
    areas = rng.integers(0, 12, size=(64, 2)).astype(np.float32)
    valid = rng.random(64) < 0.8
    want_r, want_v = jax_binning.gaussian_rects(jnp.asarray(us), jnp.asarray(areas),
                                                jnp.asarray(valid), W, H)
    got_r, got_v = binning.gaussian_rects(torch.from_numpy(us), torch.from_numpy(areas),
                                          torch.from_numpy(valid), W, H)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert binning.num_tiles(979, 546) == jax_binning.num_tiles(979, 546) == (62, 35)


def test_propagate_marks_drops_past_budget():
    starts = np.array([0, 2, 2, 5, 9, 12], np.int32)
    values = np.array([3, 7, 1, 4, 8, 6], np.int32)
    want = jax_binning._propagate_marks(jnp.asarray(starts), jnp.asarray(values), 10)
    got = binning._propagate_marks(torch.from_numpy(starts), torch.from_numpy(values), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_tile_lists_matches_jax():
    a = _stage_arrays(5)
    got, want = _bin_both(a, True, max_patches=2048)
    kmax = int(want["tile_cnt"].max())
    np.testing.assert_array_equal(
        binning.dense_tile_lists(got, max_per_tile=kmax).numpy(),
        np.asarray(jax_binning.dense_tile_lists(want, max_per_tile=kmax)))


@pytest.mark.parametrize("seed,budget", [
    (0, dict(max_patches=4096)),
    (2, dict(max_patches=256, max_rows=4096)),   # patch budget overflows
    (3, dict(max_patches=4096, max_rows=128)),   # row budget overflows
])
def test_gsid_counts_match_jax(seed, budget):
    a = _stage_arrays(seed)
    got, want = _bin_both(a, True, gsid_counts=True, **budget)
    _assert_equal(got, want)
    counts = got["gsid_counts"].numpy()
    assert got["gsid_counts"].dtype == torch.int32
    np.testing.assert_array_equal(counts, np.asarray(want["gsid_counts"]))
    # they count the kept patches of each gaussian
    gsid = got["patch_gsid"].numpy()
    np.testing.assert_array_equal(counts, np.bincount(gsid[gsid >= 0], minlength=len(counts)))
    assert "gsid_counts" not in _bin_both(a, True, **budget)[0]


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("flag,value", [("EGS_RADIX_SORT", "1"), ("EGS_XLA_GRAD_SORT", "0")])
@pytest.mark.parametrize("seed,budget", [
    (0, dict(max_patches=4096)),
    (2, dict(max_patches=256, max_rows=4096)),   # patch budget overflows
])
def test_sort_routes_match_default_route_and_jax(seed, budget, flag, value, monkeypatch):
    """The JAX package's opt-in sort routes, read from the same flags: K8's
    counting sort by tile on every backend (its plain version on the
    all-plain path), and the K7 inversion of gsid_counts on the kernel
    backend only (CPU tensors take K7's plain version inside the wrapper).
    Every integer output equals the default route's and JAX's default
    binning (computed before the flag is set: the jitted JAX binning reads
    flags while tracing and keeps the trace)."""
    a = _stage_arrays(seed)
    default, want = _bin_both(a, True, gsid_counts=True, **budget)
    monkeypatch.setenv(flag, value)
    calls = []
    _spy(monkeypatch, binning.radix, "counting_sort", calls)
    _spy(monkeypatch, binning.radix, "counting_sort_plain", calls)
    _spy(monkeypatch, binning.sort, "sort_pairs", calls)
    for use_kernels in (True, False):
        del calls[:]
        got = binning.bin_gaussians(
            torch.from_numpy(a["us"]), torch.from_numpy(a["depths"]),
            torch.from_numpy(a["areas"]), torch.from_numpy(a["valid"]), width=W, height=H,
            cinv2ds=torch.from_numpy(a["cinv2ds"]), alphas=torch.from_numpy(a["alphas"]),
            gsid_counts=True, use_kernels=use_kernels, **budget)
        if flag == "EGS_RADIX_SORT":
            # the wrapper takes its plain version for CPU tensors
            assert calls == (["counting_sort", "counting_sort_plain"] if use_kernels
                             else ["counting_sort_plain"])
        else:
            assert calls == (["sort_pairs"] if use_kernels else [])
        for k in INT_KEYS + ("gsid_counts",):
            assert torch.equal(got[k], default[k]), k
        _assert_equal(got, want)
        np.testing.assert_array_equal(got["gsid_counts"].numpy(), np.asarray(want["gsid_counts"]))


def test_lex_sort_route_matches_default_route(monkeypatch):
    """EGS_LEX_SORT=1 takes K7's two-word (tile, slot) sort only where the
    JAX package's packed key would overflow 32 bits, (n_tiles + 1) <<
    mp_bits > 2**32, and on the kernel backend: 65,536 tiles of a
    16384x1024 image at a 2^17 patch budget (mp_bits 17). The JAX binning
    is left out at this size: its [n_tiles, max_rows] compare-reduce alone
    is 2^31 elements."""
    rng = np.random.default_rng(7)
    n, w, h = 2000, 16384, 1024
    args = [torch.from_numpy(x) for x in (
        (rng.random((n, 2)) * [w, h]).astype(np.float32),
        (rng.random(n) + 1.0).astype(np.float32),
        (rng.random((n, 2)) * 40).astype(np.float32),
        rng.random(n) < 0.9)]
    kw = dict(width=w, height=h, max_patches=2**17, max_rows=2**14, gsid_counts=True)
    assert (binning.num_tiles(w, h)[0] * binning.num_tiles(w, h)[1] + 1) << 17 > 2**32
    default = binning.bin_gaussians(*args, **kw)
    monkeypatch.setenv("EGS_LEX_SORT", "1")
    calls = []
    _spy(monkeypatch, binning.sort, "sort_pairs", calls)
    got = binning.bin_gaussians(*args, **kw)
    assert calls == ["sort_pairs"] and int(got["total"]) > 10_000
    for k in INT_KEYS + ("gsid_counts",):
        assert torch.equal(got[k], default[k]), k
    binning.bin_gaussians(*args, use_kernels=False, **kw)
    assert calls == ["sort_pairs"]  # not on the all-plain path


# K12's route (ops/binning.py::takes_kernel), decided on what the call can
# observe. A stand-in carries a CUDA device, and a stand-in K12 records its
# calls, so nothing here needs the card or nvcc.
CUDA_F32 = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32, shape=(1, 2))


@pytest.mark.parametrize("us,use_kernels,size,want", [
    (CUDA_F32, True, (64, 48), True),
    (CUDA_F32, False, (64, 48), False),             # the plain version
    (torch.zeros((1, 2)), True, (64, 48), False),   # CPU tensors
    (SimpleNamespace(device=torch.device("cuda"), dtype=torch.float64, shape=(1, 2)), True,
     (64, 48), True),                               # float64: K12, which raises on it
    (CUDA_F32, True, (4096, 4096), True),           # 65,536 tiles: no size threshold
])
def test_kernel_route_choice(monkeypatch, us, use_kernels, size, want):
    assert binning.takes_kernel(us, use_kernels) is want
    if not want:
        return
    calls = []
    monkeypatch.setattr(binning.kernel_binning, "bin_lists",
                        lambda *a, gx, gy, **kw: calls.append(gx * gy) or {})
    out = binning.bin_gaussians(us, None, None, None, width=size[0], height=size[1],
                                max_patches=4096)
    assert out == {"kernel": True}
    assert calls == [binning.num_tiles(*size)[0] * binning.num_tiles(*size)[1]]


@pytest.mark.parametrize("flag,value,want", [
    ("EGS_RADIX_SORT", "1", False), ("EGS_LEX_SORT", "1", False),
    ("EGS_XLA_GRAD_SORT", "0", False),
    ("EGS_RADIX_SORT", "0", True), ("EGS_LEX_SORT", "0", True),
    ("EGS_XLA_GRAD_SORT", "1", True), ("EGS_GRAD_PERM", "0", True),
    ("EGS_RADIX_REDUCE", "1", True),
])
def test_kernel_route_under_sort_flags(monkeypatch, flag, value, want):
    """The opt-in sort routes of binning keep the slot path (K7's and K8's
    routes); the reduce's flags and the flags' off values leave K12 on."""
    for name in ("EGS_RADIX_SORT", "EGS_LEX_SORT", "EGS_XLA_GRAD_SORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(flag, value)
    assert binning.takes_kernel(CUDA_F32, True) is want


@pytest.mark.parametrize("use_kernels", [True, False])
def test_cpu_tensors_take_the_slot_path(monkeypatch, use_kernels):
    calls = []
    _spy(monkeypatch, binning.kernel_binning, "bin_lists", calls)
    a = _stage_arrays(0)
    got = binning.bin_gaussians(
        torch.from_numpy(a["us"]), torch.from_numpy(a["depths"]),
        torch.from_numpy(a["areas"]), torch.from_numpy(a["valid"]), width=W, height=H,
        cinv2ds=torch.from_numpy(a["cinv2ds"]), alphas=torch.from_numpy(a["alphas"]),
        max_patches=4096, gsid_counts=True, use_kernels=use_kernels)
    assert got["kernel"] is False and calls == []


@pytest.mark.parametrize("k12", [False, True])
def test_binning_kernel_counter(monkeypatch, k12):
    """``binning.kernel`` reads 1 where K12 built the lists and 0 where the
    slot path did. K12 itself runs only on the card: here a stand-in with
    its signature returns the slot path's lists, and the route is forced."""
    a = _stage_arrays(1)
    t = {k: torch.from_numpy(a[k]) for k in a}
    colors = torch.from_numpy(np.random.default_rng(1).random((len(a["us"]), 3),
                                                              dtype=np.float32))
    kw = dict(width=W, height=H, backend="tiled", max_patches=4096, need_grads=False)
    slot = binning.bin_gaussians(t["us"], t["depths"], t["areas"], t["valid"], width=W,
                                 height=H, max_patches=4096, cinv2ds=t["cinv2ds"],
                                 alphas=t["alphas"], use_kernels=False)
    calls = []
    if k12:
        monkeypatch.setattr(binning, "takes_kernel", lambda *args: True)

        def stand_in(us, depths, areas, valid, *, cinv2ds=None, alphas=None, gx, gy,
                     max_patches, max_rows, gsid_counts=False):
            calls.append((gx, gy, max_patches, max_rows, gsid_counts))
            return {k: v for k, v in slot.items() if k != "kernel"}

        monkeypatch.setattr(binning.kernel_binning, "bin_lists", stand_in)
    tracer = trace.enable()
    try:
        with trace.request("render"):
            image, aux = raster_from_aux(*(t[k] for k in ("us", "cinv2ds", "alphas")), colors,
                                         *(t[k] for k in ("depths", "areas", "valid")), **kw)
    finally:
        trace.disable()
    (root,) = tracer.named("render")
    assert root.counters["binning.kernel"] == int(k12)
    assert aux["binning"]["kernel"] is k12
    assert calls == ([(4, 3, 4096, 4096, False)] if k12 else [])
    for k in INT_KEYS:
        assert torch.equal(aux["binning"][k], slot[k]), k
