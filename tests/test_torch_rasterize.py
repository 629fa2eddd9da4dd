"""PyTorch port: the plain version of K4 (the stage-6 wrapper on CPU tensors)
against the JAX Pallas rasteriser run through the interpreter, on the same
binning; and the blend constants that csrc/blend.cuh shares with both
packages."""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu.data import example_camera
from easygaussiansplatting_tpu.models import Camera as JaxCamera
from easygaussiansplatting_tpu.ops import stages as jax_stages
from easygaussiansplatting_tpu.ops.binning import bin_gaussians as jax_bin
from easygaussiansplatting_tpu.ops.pallas import kernels as jax_kernels
from easygaussiansplatting_tpu.ops.pallas.rasterize import rasterize_pallas
from easygaussiansplatting_tpu_torch.data.fixtures import stacked_tile
from easygaussiansplatting_tpu_torch.ops import blend, rasterize_tiled
from easygaussiansplatting_tpu_torch.ops.kernels import preprocess, rasterize
from easygaussiansplatting_tpu_torch.probes import chunk_stop

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


def _assert_match(got, want, height=H, width=W):
    (img, tau, cont), (img_j, raux_j) = got, want
    assert img.shape == (3, height, width) and tau.shape == cont.shape == (height, width)
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


def test_wrapper_counters_on_the_plain_version():
    """On CPU tensors K4's counters say what the plain version does: every
    tile one item, none left, no pixel walked again."""
    f = stacked_tile(70)
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    s = t["us"].shape[0]
    table = preprocess.pack_table(t["us"], t["cinv2ds"], t["alphas"], t["colors"],
                                  torch.zeros(s), torch.zeros((s, 2)))
    counters = {}
    got = rasterize.rasterize_fwd(table, t["patch_gsid"], t["tile_start"], t["tile_cnt"],
                                  width=16, height=16, counters=counters)
    want = rasterize.rasterize_plain(table, t["patch_gsid"], t["tile_start"], t["tile_cnt"],
                                     width=16, height=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert list(counters) == list(rasterize.COUNTERS)
    assert [int(v) for v in counters.values()] == [1, 0, 0]
    assert all(v.dim() == 0 for v in counters.values())


# (tiles, resident CTAs) -> K4's chunk length: a 160x120 preview (80 tiles),
# the 640x480 frame (1,200), the bench's 979x546 (2,170), one tile, and the
# edge where a tile gets two CTAs and where it gets one; on an H100's 1,584
# resident CTAs the preview, the full frame, F2 and a viewer band of a
# quarter of a preview (20 tiles), and no tile
CHUNK_CASES = [((80, 1584), 224), ((80, 2640), 128), ((80, 4224), 96), ((1200, 2640), 2048),
               ((1320, 2640), 2048), ((1321, 2640), 0), ((2170, 2640), 0), ((2170, 4224), 0),
               ((1, 2640), 64), ((300, 2640), 512), ((0, 2640), 64), ((40, 100), 2048),
               ((1200, 1584), 0), ((2170, 1584), 0), ((20, 1584), 64), ((792, 1584), 2048),
               ((793, 1584), 0)]


@pytest.mark.parametrize("tiles_resident,want", CHUNK_CASES)
def test_k4_chunk_length_follows_the_tiles_and_the_card(tiles_resident, want):
    """L = 0 (a CTA a tile) where a tile gets fewer than two resident CTAs,
    else WAVE_DEPTH over its CTAs rounded up to CHUNK_ALIGN, at least
    MIN_CHUNK and at most WAVE_DEPTH / 2."""
    got = rasterize.chunk_length(*tiles_resident)
    assert got == want
    if got:
        assert got % rasterize.CHUNK_ALIGN == 0
        assert rasterize.MIN_CHUNK <= got <= rasterize.WAVE_DEPTH // 2


# list lengths at and around the kernels' batch sizes (K5 stages 64 entries
# a batch, K4 128) and the TPU kernel's 256-entry chunks
STACK_SIZES = (63, 64, 65, 127, 128, 129, 255, 256, 257, 511, 512, 513)


def stacked_both(n):
    """The stacked tile through the port's plain K4 and the interpreted
    Pallas forward. Returns ((image, final_tau, contrib), (image, aux) of
    JAX, the port's table and binning tensors)."""
    f = stacked_tile(n)
    b = {k: jnp.asarray(f[k]) for k in ("patch_gsid", "tile_start", "tile_cnt")}
    b["total"] = jnp.int32(n)
    want = rasterize_pallas(*(jnp.asarray(f[k]) for k in ("us", "cinv2ds", "alphas", "colors")),
                            b, width=16, height=16, k_chunk=128, interpret=True)
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    s = t["us"].shape[0]
    table = preprocess.pack_table(t["us"], t["cinv2ds"], t["alphas"], t["colors"],
                                  torch.zeros(s), torch.zeros((s, 2)))
    bins = (t["patch_gsid"], t["tile_start"], t["tile_cnt"])
    got = rasterize.rasterize_fwd(table, *bins, width=16, height=16)
    return got, want, table, bins


@pytest.mark.parametrize("n", STACK_SIZES)
def test_plain_k4_matches_pallas_on_stacked_tile(n):
    got, want, _, _ = stacked_both(n)
    img, tau, cont = got
    assert 0 < int((tau < 1e-4).sum()) < 256  # some pixels saturate, some walk the list
    assert int(cont.max()) == n
    _assert_match(got, want, height=16, width=16)


BLEND_CUH = Path(rasterize.__file__).resolve().parents[2] / "csrc" / "blend.cuh"


def _cuh_constant(name):
    m = re.search(rf"constexpr float {name} = ([-+0-9.eE]+)f;", BLEND_CUH.read_text())
    assert m, f"{name} not found in {BLEND_CUH}"
    return float(np.float32(m.group(1)))


@pytest.mark.parametrize("name", ["ALPHA_CLAMP", "ALPHA_SKIP", "TAU_STOP"])
def test_blend_constants_agree(name):
    """The thresholds of csrc/blend.cuh equal the JAX package's
    (ops/pallas/kernels.py) and the port's plain version's (ops/blend.py)."""
    assert _cuh_constant(name) == float(np.float32(getattr(jax_kernels, name)))
    assert _cuh_constant(name) == float(np.float32(getattr(blend, name)))


def test_blend_cutoff_is_conservative():
    """The kernels skip a pair without its exponential where e = -0.5
    log2(e) maha < log2(ALPHA_SKIP / alpha) - CUTOFF_MARGIN. At that cutoff,
    alpha' of the plain version (float32 torch.exp of -0.5 maha) is below
    ALPHA_SKIP for alphas from the threshold to 1, and the pre-scale is
    -0.5 log2(e)."""
    margin = _cuh_constant("CUTOFF_MARGIN")
    assert margin > 0
    assert _cuh_constant("NEG_HALF_LOG2E") == float(np.float32(-0.5 / math.log(2.0)))
    alpha = torch.cat([torch.linspace(blend.ALPHA_SKIP, 1.0, 100001),
                       torch.tensor([blend.ALPHA_SKIP * 1.0001, 0.5, 0.99, 1.0])])
    cut = math.log2(blend.ALPHA_SKIP) - torch.log2(alpha.double()) - margin  # on e
    maha = (cut / (-0.5 / math.log(2.0))).float()  # the maha of e = cut
    ap = alpha * torch.exp(-0.5 * torch.clamp(maha, min=0.0))
    assert float(ap.max()) < blend.ALPHA_SKIP


def _f32_prod(x, dim):
    """torch.prod in float32, last entry first: an order in which the product
    rounds apart from torch.cumprod's, fixed so that the test does not rest
    on the order the installed torch's prod happens to take."""
    out = x.select(dim, -1)
    for i in range(x.shape[dim] - 2, -1, -1):
        out = out * x.select(dim, i)
    return out


def test_stop_inside_a_chunk_carries_over(monkeypatch):
    """A pixel whose transmittance falls below TAU_STOP inside a chunk leaves
    the chunk below it, however the chunk's product rounds: otherwise a
    later chunk contributes behind the entries this one excluded, which the
    backward's replay (every live entry below contrib) cannot represent. The
    chunk's 16 entries cover every pixel at alpha' = alpha; the 64 pixels
    enter it with consecutive float32 transmittances that put the tenth
    entry's on the threshold."""
    rng = np.random.default_rng(3)
    k, p = 16, 64
    alpha = torch.from_numpy(rng.uniform(0.3, 0.6, k).astype(np.float32))
    base = np.float32(1e-4 / float(torch.cumprod(1 - alpha, 0)[9]))
    tau_in = torch.from_numpy((base + (np.arange(p) - p // 2) * np.spacing(base))
                              .astype(np.float32))
    zeros = torch.zeros(p)
    chunk = (torch.zeros((k, 2)), torch.zeros((k, 3)), alpha, torch.rand((k, 3)),
             torch.ones(k, dtype=torch.bool), zeros, zeros)
    monkeypatch.setattr(torch, "prod", _f32_prod)
    excl = torch.cumprod(torch.cat([torch.ones(1), 1 - alpha[:-1]]), 0)
    tau_ex = tau_in[None] * excl[:, None]
    stopped = (tau_ex < blend.TAU_STOP).any(0)
    product = tau_in * _f32_prod(torch.where(tau_ex >= blend.TAU_STOP, 1 - alpha[:, None], 1.0), 0)
    assert bool((stopped & (product >= blend.TAU_STOP)).any())  # the rounding this guards
    _, tau_out, cont = blend.blend_chunk_fwd(tau_in, *chunk)
    assert bool(stopped.all()) and float(tau_out.max()) < blend.TAU_STOP
    _, _, cont_next = blend.blend_chunk_fwd(tau_out, *chunk)
    assert int(cont_next.max()) == 0 and int(cont.min()) >= 9


def test_chunk_stop_probe_resumes_no_pixel(monkeypatch):
    """probes/chunk_stop.py on 16 tiles whose pixels stop within ulps of
    1e-4 inside their first chunk: with the chunk's product in an order
    that rounds apart from the cumulative one, the product exit lets the
    second chunk take pixels again; the plain forward's stop exit takes
    none, and its backward equals the kernels' wrappers' (on the CPU, the
    same plain versions)."""
    monkeypatch.setattr(torch, "prod", _f32_prod)
    out = chunk_stop.run("cpu", n_tiles=16)
    assert out["k4_stopped"] == out["pixels"] == 16 * 256
    assert out["product"]["resumed"] > 0
    assert out["stop"] == {"resumed": 0, "contrib_differs_from_k4": 0, "grad_err_of_max": 0.0}
