"""PyTorch port: the stage-6 backward (K5's plain version and the
sort-reduce, through ``RasterizeFunction`` on CPU tensors) against the JAX
Pallas backward run through the interpreter (``backward_kernel``) and against
autodiff of the JAX tiled rasteriser: the [N, 9] table cotangent, and the
parameter gradients of sum(w * image) through the whole render."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.data import example_camera
from easygaussiansplatting_tpu.models import Camera as JaxCamera
from easygaussiansplatting_tpu.ops import stages as jax_stages
from easygaussiansplatting_tpu.ops.binning import bin_gaussians as jax_bin
from easygaussiansplatting_tpu.ops.pallas.rasterize import rasterize_pallas
from easygaussiansplatting_tpu.ops.rasterize import render as jax_render
from easygaussiansplatting_tpu_torch.data.fixtures import stacked_tile
from easygaussiansplatting_tpu_torch.models.convert import camera_from_numpy
from easygaussiansplatting_tpu_torch.ops.kernels import rasterize
from easygaussiansplatting_tpu_torch.ops.kernels.preprocess import TABLE_COLS, pack_table
from easygaussiansplatting_tpu_torch.ops.rasterize import render
from easygaussiansplatting_tpu_torch.ops.rasterize_tiled import K_CHUNK

torch.set_num_threads(2)

KEYS = ("pws", "shs", "alphas", "scales", "rots")
JCAM = JaxCamera.from_dict(example_camera())


def _assert_grads(got, want, names):
    """The JAX package's kernel-vs-AD tolerance (tests/test_pallas.py):
    atol 5e-4 * max(1, max|g|) per group, for fp32 sums taken in another
    order."""
    for g, w, name in zip(got, want, names):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=5e-4 * scale, rtol=0, err_msg=name)


def _random_scene(rng, n=120, deg=0):
    pws = rng.normal(size=(n, 3)) * np.array([1.5, 1.0, 1.5])
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    return [a.astype(np.float32) for a in (
        pws, rng.normal(size=(n, 3 * (deg + 1) ** 2)) * 0.5,
        1 / (1 + np.exp(-rng.normal(size=n))), np.exp(rng.normal(size=(n, 3)) * 0.4 - 2.2),
        rots)]


def _stack_scene(rng, n=300):
    """An opaque stack (saturates tau; tile lists longer than K_CHUNK) plus a
    spread."""
    pws = np.concatenate([rng.normal(size=(n // 2, 3)) * 0.02,
                          rng.normal(size=(n - n // 2, 3)) * np.array([1.5, 1.0, 1.5])])
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    return [a.astype(np.float32) for a in (
        pws, rng.normal(size=(n, 3)) * 0.5, np.full(n, 0.95),
        np.exp(rng.normal(size=(n, 3)) * 0.3 - 1.8), rots)]


def _table_cotangent_both(arrays, jcam, w, max_patches):
    """d sum(w * image) / d table on the JAX stage arrays and JAX binning."""
    aux = jax_stages.preprocess(*(jnp.asarray(a) for a in arrays), jcam, sh_degree=0)
    b = jax_bin(aux["us"], aux["depths"], aux["areas"], aux["valid"], width=jcam.width,
                height=jcam.height, max_patches=max_patches, cinv2ds=aux["cinv2ds"],
                alphas=aux["alphas"], gsid_counts=True)
    jtable = jnp.concatenate([aux["us"], aux["cinv2ds"], aux["alphas"][:, None],
                              aux["colors"], jnp.zeros((len(arrays[0]), 7))], axis=1)

    def f(table):
        img, _ = rasterize_pallas(aux["us"], aux["cinv2ds"], aux["alphas"], aux["colors"], b,
                                  width=jcam.width, height=jcam.height, k_chunk=128,
                                  interpret=True, table=table)
        return jnp.sum(img * w)

    want = np.asarray(jax.grad(f)(jtable))[:, :9]
    t = {k: torch.from_numpy(np.array(aux[k])) for k in
         ("us", "cinv2ds", "alphas", "colors", "depths", "areas")}
    table = pack_table(t["us"], t["cinv2ds"], t["alphas"], t["colors"], t["depths"],
                       t["areas"]).requires_grad_()
    tb = [torch.from_numpy(np.array(b[k])) for k in
          ("patch_gsid", "tile_start", "tile_cnt", "gsid_counts")]
    img, _, _ = rasterize.RasterizeFunction.apply(table, *tb, jcam.width, jcam.height, True)
    (got,) = torch.autograd.grad((img * torch.from_numpy(w)).sum(), table)
    assert got.shape == (len(arrays[0]), TABLE_COLS)
    assert float(got[:, 9:].abs().max()) == 0.0
    return got[:, :9].numpy(), want, b


@pytest.mark.parametrize("seed", [0, 1])
def test_table_cotangent_matches_pallas(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(3, 16, 32)).astype(np.float32)
    got, want, _ = _table_cotangent_both(_random_scene(rng), JCAM, w, 4096)
    assert np.abs(want).max() > 0
    _assert_grads(got.T, want.T, ["ux", "uy", "ca", "cb", "cc", "alpha", "r", "g", "b"])


def test_table_cotangent_saturating_stack():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(3, 16, 32)).astype(np.float32)
    got, want, b = _table_cotangent_both(_stack_scene(rng), JCAM, w, 8192)
    assert int(np.asarray(b["tile_cnt"]).max()) > K_CHUNK
    _assert_grads(got.T, want.T, ["ux", "uy", "ca", "cb", "cc", "alpha", "r", "g", "b"])


@pytest.mark.parametrize("n", [63, 64, 65, 127, 128, 129, 255, 256, 257, 511, 512, 513])
def test_plain_k5_matches_pallas_on_stacked_tile(n):
    """K5's plain version on the stacked tile (lists at and around the
    kernels' batch sizes, saturated and unsaturated pixels, alpha' on the
    0.002 and 0.99 thresholds, dropped entries) against autodiff of the
    interpreted Pallas rasteriser: entry j is gaussian j, so the [9, M]
    per-patch rows are the table cotangent's first nine columns."""
    f = stacked_tile(n)
    w = np.random.default_rng(n).normal(size=(3, 16, 16)).astype(np.float32)
    b = {k: jnp.asarray(f[k]) for k in ("patch_gsid", "tile_start", "tile_cnt")}
    b["total"] = jnp.int32(n)
    attrs = [jnp.asarray(f[k]) for k in ("us", "cinv2ds", "alphas", "colors")]
    s = f["us"].shape[0]
    jtable = jnp.concatenate([attrs[0], attrs[1], attrs[2][:, None], attrs[3],
                              jnp.zeros((s, 7))], axis=1)

    def loss(table):
        img, _ = rasterize_pallas(*attrs, b, width=16, height=16, k_chunk=128, interpret=True,
                                  table=table)
        return jnp.sum(img * w)

    want = np.asarray(jax.grad(loss)(jtable))[:, :9].T
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    table = pack_table(t["us"], t["cinv2ds"], t["alphas"], t["colors"], torch.zeros(s),
                       torch.zeros((s, 2)))
    bins = (t["patch_gsid"], t["tile_start"], t["tile_cnt"])
    _, tau, cont = rasterize.rasterize_fwd(table, *bins, width=16, height=16)
    assert 0 < int((tau < 1e-4).sum()) < 256 and int(cont.max()) == n
    got = rasterize.rasterize_bwd(table, *bins, torch.from_numpy(w), tau, cont, width=16,
                                  height=16).numpy()
    assert got.shape == (9, s)
    assert np.abs(want).max() > 0 and np.all(got[:, f["patch_gsid"] < 0] == 0.0)
    _assert_grads(got, want, ["ux", "uy", "ca", "cb", "cc", "alpha", "r", "g", "b"])


def _render_grads_port(arrays, cam, w, deg, max_patches, alive=None):
    params = [torch.from_numpy(a).requires_grad_() for a in arrays]
    img, aux = render(*params, cam, sh_degree=deg, max_patches=max_patches, device="cpu",
                      alive=None if alive is None else torch.from_numpy(alive))
    return [g.numpy() for g in torch.autograd.grad((img * torch.from_numpy(w)).sum(), params)]


def _render_grads_jax(arrays, jcam, w, deg, alive=None, **kw):
    def f(*a):
        img, _ = jax_render(*a, jcam, sh_degree=deg,
                            alive=None if alive is None else jnp.asarray(alive), **kw)
        return jnp.sum(img * w)
    return [np.asarray(g) for g in
            jax.grad(f, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in arrays))]


@pytest.mark.parametrize("seed,deg", [(0, 0), (3, 3)])
def test_render_gradients_match_pallas_and_tiled(seed, deg):
    """With an alive mask: dead gaussians are not drawn and take no
    gradient."""
    rng = np.random.default_rng(seed)
    arrays = _random_scene(rng, n=100, deg=deg)
    alive = rng.random(100) < 0.8
    w = rng.normal(size=(3, 16, 32)).astype(np.float32)
    got = _render_grads_port(arrays, camera_from_numpy(JCAM), w, deg, 4096, alive)
    pallas = _render_grads_jax(arrays, JCAM, w, deg, alive, backend="pallas", k_chunk=128,
                               max_patches=4096)
    tiled = _render_grads_jax(arrays, JCAM, w, deg, alive, backend="tiled", k_chunk=64,
                              n_chunks=16, max_patches=4096)
    _assert_grads(got, pallas, KEYS)
    _assert_grads(got, tiled, KEYS)
    assert all(np.all(g[~alive] == 0.0) for g in got)


def test_render_gradients_saturating_stack():
    rng = np.random.default_rng(4)
    arrays = _stack_scene(rng)
    w = rng.normal(size=(3, 16, 32)).astype(np.float32)
    got = _render_grads_port(arrays, camera_from_numpy(JCAM), w, 0, 8192)
    tiled = _render_grads_jax(arrays, JCAM, w, 0, backend="tiled", k_chunk=64, n_chunks=32,
                              max_patches=8192)
    _assert_grads(got, tiled, KEYS)


def test_render_gradients_far_tile_origin():
    """Tiles whose origins sit ~900 pixels from (0, 0) (the far columns of a
    992-wide image): the tile-local offsets and the origin shift of the
    backward."""
    rng = np.random.default_rng(5)
    w_, h_ = 992, 48
    jcam = JaxCamera.from_dict(dict(example_camera(), width=w_, height=h_, cx=w_ / 2.0,
                                    cy=h_ / 2.0, fx=400.0, fy=400.0))
    n = 24
    zs = 2.0 + rng.uniform(size=n)
    xs = (rng.uniform(size=n) * 120 + 820 - jcam.cx) / jcam.fx * zs
    ys = (rng.uniform(size=n) * 40 + 4 - jcam.cy) / jcam.fy * zs
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    arrays = [a.astype(np.float32) for a in (
        np.stack([xs, ys, zs], axis=1), rng.normal(size=(n, 3)) * 0.5,
        1 / (1 + np.exp(-rng.normal(size=n))), np.exp(rng.normal(size=(n, 3)) * 0.3 - 2.8),
        rots)]
    wimg = rng.normal(size=(3, h_, w_)).astype(np.float32)
    got = _render_grads_port(arrays, camera_from_numpy(jcam), wimg, 0, 4096)
    tiled = _render_grads_jax(arrays, jcam, wimg, 0, backend="tiled", k_chunk=64, n_chunks=4,
                              max_patches=4096)
    assert np.abs(tiled[0]).max() > 0
    _assert_grads(got, tiled, KEYS)


def test_bwd_wrapper_rejects_bad_inputs():
    table = torch.zeros((4, TABLE_COLS))
    gsid = torch.zeros(8, dtype=torch.int32)
    start = cnt = torch.zeros(2, dtype=torch.int32)
    img, tau, cont = torch.zeros((3, 16, 32)), torch.ones((16, 32)), torch.zeros(
        (16, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="contrib"):
        rasterize.rasterize_bwd(table, gsid, start, cnt, img, tau, cont.long(), width=32,
                                height=16)
    with pytest.raises(ValueError, match="g_image"):
        rasterize.rasterize_bwd(table, gsid, start, cnt, img[:, :8], tau, cont, width=32,
                                height=16)


REDUCE_FLAGS = ("EGS_RADIX_REDUCE", "EGS_GRAD_PERM", "EGS_XLA_GRAD_SORT")


@pytest.mark.parametrize("route,kernel", [
    ({}, None),
    ({"EGS_XLA_GRAD_SORT": "0"}, "sort_pairs"),
    ({"EGS_GRAD_PERM": "0"}, "sort_pairs"),
    ({"EGS_RADIX_REDUCE": "1"}, "counting_sort"),
])
def test_sort_reduce_routes_match_jax_and_scatter(route, kernel, monkeypatch):
    """The gradient reduce under each of the JAX package's sort routes (the
    flags are read on each call on both sides) against JAX
    ``_sort_reduce_grads`` under the same flags and the numpy scatter-add,
    at tests/test_pallas.py's atol 1e-4; the patch->gaussian map has the
    real structure (contiguous per-gaussian patches, a dead tail, unused
    gaussians) and the patches arrive permuted."""
    from easygaussiansplatting_tpu.ops.pallas.rasterize import GRAD_USED, _sort_reduce_grads

    rng = np.random.default_rng(0)
    n, m = 37, 512
    counts = rng.integers(0, 40, size=n).astype(np.int32)
    counts[rng.integers(0, n, size=5)] = 0
    gsid = np.concatenate([np.full(c, g, np.int32) for g, c in enumerate(counts)])[:m]
    counts = np.bincount(gsid, minlength=n).astype(np.int32)
    live = np.zeros(m, bool)
    live[: gsid.shape[0]] = True
    gsafe = np.zeros(m, np.int32)
    gsafe[: gsid.shape[0]] = gsid
    perm = rng.permutation(m)
    rows = rng.normal(size=(GRAD_USED, m)).astype(np.float32)
    rows[:, ~live[perm]] = 0.0
    for flag in REDUCE_FLAGS:
        monkeypatch.delenv(flag, raising=False)
    for k, v in route.items():
        monkeypatch.setenv(k, v)
    want_jax = np.asarray(_sort_reduce_grads(jnp.asarray(rows), jnp.asarray(gsafe[perm]),
                                             jnp.asarray(live[perm]), jnp.asarray(counts), n))
    want = np.zeros((GRAD_USED, n), np.float32)
    np.add.at(want.T, gsafe[perm][live[perm]], rows.T[live[perm]])
    patch_gsid = torch.from_numpy(np.where(live[perm], gsafe[perm], -1).astype(np.int32))
    calls = []
    module = rasterize.radix if kernel == "counting_sort" else rasterize.sort
    if kernel is not None:
        fn = getattr(module, kernel)
        monkeypatch.setattr(module, kernel, lambda *a, **kw: calls.append(kernel) or fn(*a, **kw))
    for use_kernels in (True, False):
        got = rasterize.sort_reduce_grads(torch.from_numpy(rows), patch_gsid,
                                          torch.from_numpy(counts), use_kernels).numpy()
        assert got.shape == (n, GRAD_USED)
        np.testing.assert_allclose(got.T, want_jax, atol=1e-4)
        np.testing.assert_allclose(got.T, want, atol=1e-4)
    assert calls == ([] if kernel is None else [kernel])  # the kernel wrapper, on its route
