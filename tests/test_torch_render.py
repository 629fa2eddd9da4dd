"""PyTorch port: the forward render slice end to end against the JAX render
(Pallas backend, interpreted) and the float64 golden model; device
selection; import isolation from JAX; the render CLI."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easygaussiansplatting_tpu import golden
from easygaussiansplatting_tpu.data import example_camera, example_gaussians
from easygaussiansplatting_tpu.models import Camera as JaxCamera
from easygaussiansplatting_tpu.ops.rasterize import render as jax_render
from easygaussiansplatting_tpu_torch.models.convert import camera_from_numpy
from easygaussiansplatting_tpu_torch.ops.rasterize import resolve_backend
from easygaussiansplatting_tpu_torch.ops.rasterize import render as torch_render

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("pws", "shs", "alphas", "scales", "rots")
BIN_KEYS = ("patch_gsid", "patch_tile", "tile_start", "tile_cnt", "total",
            "n_dropped", "rows_dropped", "total_rows")


def _scene(rng, n=150, deg=3):
    pws = rng.normal(size=(n, 3)) * np.array([1.5, 1.0, 1.5])
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    return {"pws": pws, "rots": rots,
            "scales": np.exp(rng.normal(size=(n, 3)) * 0.4 - 2.2),
            "alphas": 1 / (1 + np.exp(-rng.normal(size=n))),
            "shs": rng.normal(size=(n, 3 * (deg + 1) ** 2)) * 0.3}


def _render_both(g, camd, deg, max_patches=4096):
    jcam = JaxCamera.from_dict(camd)
    img_j, aux_j = jax_render(*(jnp.asarray(g[k], jnp.float32) for k in KEYS), jcam,
                              sh_degree=deg, backend="pallas", k_chunk=128,
                              max_patches=max_patches)
    img_t, aux_t = torch_render(*(g[k] for k in KEYS), camera_from_numpy(jcam),
                                sh_degree=deg, max_patches=max_patches, device="cpu")
    # name the stage that fails: binning first
    for k in BIN_KEYS:
        np.testing.assert_array_equal(aux_t["binning"][k].numpy(),
                                      np.asarray(aux_j["binning"][k]), err_msg=k)
    return (img_t, aux_t), (img_j, aux_j)


@pytest.mark.parametrize("seed,deg", [(0, 3), (1, 0)])
def test_render_matches_jax_pallas(seed, deg):
    g = _scene(np.random.default_rng(seed), deg=deg)
    (img_t, aux_t), (img_j, aux_j) = _render_both(g, example_camera(), deg)
    assert img_t.shape == (3, 16, 32) and img_t.dtype == torch.float32
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
    np.testing.assert_allclose(aux_t["final_tau"].numpy(), np.asarray(aux_j["final_tau"]),
                               atol=1e-4)
    np.testing.assert_array_equal(aux_t["contrib"].numpy(), np.asarray(aux_j["contrib"]))
    assert int(aux_t["n_patches"]) == int(aux_j["n_patches"])


def test_render_matches_golden_and_jax_on_fixture():
    gs = example_gaussians()
    camd = example_camera()
    (img_t, aux_t), (img_j, _) = _render_both(gs, camd, deg=0, max_patches=256)
    img_g, aux_g = golden.render(
        gs["pws"], gs["shs"], gs["alphas"], gs["scales"], gs["rots"], camd["Rcw"],
        camd["tcw"], camd["fx"], camd["fy"], camd["cx"], camd["cy"],
        camd["width"], camd["height"],
    )
    assert float(img_g.max()) > 0.1
    np.testing.assert_allclose(img_t.numpy(), img_g, atol=1e-4)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
    np.testing.assert_allclose(aux_t["final_tau"].numpy(), aux_g["final_tau"], atol=1e-4)
    np.testing.assert_array_equal(aux_t["contrib"].numpy(), aux_g["contrib"])


def test_render_budget_overflow_reports_drops(rng):
    g = _scene(rng, n=300, deg=0)
    _, aux = torch_render(*(g[k] for k in KEYS), camera_from_numpy(example_camera()),
                          sh_degree=0, max_patches=64, device="cpu")
    assert int(aux["binning"]["n_dropped"]) == int(aux["n_patches"]) - 64 > 0


def test_render_without_device_raises_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    gs = example_gaussians()
    with pytest.raises(RuntimeError, match="cuda"):
        torch_render(*(gs[k] for k in KEYS), camera_from_numpy(example_camera()), sh_degree=0)


def test_resolve_backend():
    assert resolve_backend("auto", "cpu") == "tiled"
    assert resolve_backend("auto", "cuda") == "cuda"
    assert resolve_backend("tiled", "cuda") == "tiled"
    with pytest.raises(ValueError):
        resolve_backend("cuda", "cpu")
    with pytest.raises(ValueError):
        resolve_backend("pallas", "cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import easygaussiansplatting_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k.startswith('easygaussiansplatting_tpu.')\n"
        "             or k == 'easygaussiansplatting_tpu')\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules if m.startswith(p.__name__)))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 40  # every module was imported, the two CLIs' among them
    for mod in ("train.__main__", "bench", "train.checkpoint", "ops.kernels.sort",
                "ops.kernels.radix", "utils.envflag", "probes.micro_bench",
                "probes.exp_dma_stream", "golden.model", "golden.numdiff", "golden.analytic",
                "eval", "verify_gradients"):
        assert f"easygaussiansplatting_tpu_torch.{mod}" in names, mod


def test_cli_renders_fixture_on_cpu(tmp_path):
    out = tmp_path / "fixture.png"
    res = subprocess.run(
        [sys.executable, "-m", "easygaussiansplatting_tpu_torch.render",
         "--device", "cpu", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (16, 32, 3) and img.max() > 0

